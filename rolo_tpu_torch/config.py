"""The reference's configuration, shared by loading `rolo_tpu/config.py` by path.

`rolo_tpu/config.py` is plain dataclasses with no JAX, but importing it as
`rolo_tpu.config` runs `rolo_tpu/__init__.py`, which imports JAX. Loading the
file directly keeps one source of truth for every default without pulling
JAX into the port. The module is registered in `sys.modules` before it is
executed so its dataclasses can resolve their own module.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_MODULE_NAME = "rolo_tpu_torch._rolo_config"
_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rolo_tpu", "config.py"
)


def _load():
    mod = sys.modules.get(_MODULE_NAME)
    if mod is None:
        spec = importlib.util.spec_from_file_location(_MODULE_NAME, _CONFIG_PATH)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[_MODULE_NAME] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[_MODULE_NAME]
            raise
    return mod


_cfg = _load()
RoloConfig = _cfg.RoloConfig
RegistrationConfig = _cfg.RegistrationConfig
StaticConfig = _cfg.StaticConfig
load_config = _cfg.load_config

__all__ = ["RoloConfig", "RegistrationConfig", "StaticConfig", "load_config"]
