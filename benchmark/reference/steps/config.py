"""The registration parameters, as the copied front-end reads them: the
fields of `RegistrationConfig` in `rolo_tpu_torch/config.py`, taken from a
configuration file's pin (`benchmark/configs/<config>.json`)."""

from __future__ import annotations

from types import SimpleNamespace


class RegistrationConfig(SimpleNamespace):
    """Attribute access to the pinned `registration` fields."""
