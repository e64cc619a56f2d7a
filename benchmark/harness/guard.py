"""The check that a run loaded neither JAX nor the JAX package.

A module's top-level name is the part of its name before the first dot,
compared whole: `rolo_tpu_torch` (the system under test) begins with
`rolo_tpu` (the JAX package) and must pass, `rolo_tpu.config` must not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rolo_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names whose top-level name is forbidden, sorted."""
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    """What `sys.modules` holds of JAX or the JAX package now."""
    return forbidden_modules(list(sys.modules))
