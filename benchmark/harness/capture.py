"""Taps on the program's two kernel entries and its front-end step, from
the benchmark's side.

A tap replaces the entry in every module of the program that imported it
by name, and leaves the defining module alone (its launch counter stays
where the program keeps it). Off, a tap is one Python call. On, it keeps
copies of the operands and outputs of the calls the check compares, or
records the shapes of the calls of the traced sub-window for the
rooflines. With a `replacement` (the control, or a planted fault) the
entry computes that instead. The step tap keeps copies of the arguments
and results of the steps the check compares.
"""

from __future__ import annotations

import importlib
import sys
from typing import Callable, List, Optional

import torch

PROGRAM = "rolo_tpu_torch"

# (tap name, defining module, entry)
ENTRIES = {
    "knn_moments": (f"{PROGRAM}.ops.knn_moments", "knn_moments"),
    "keyed_sum": (f"{PROGRAM}.ops.voxel_join", "keyed_matmul"),
}


def _copy(value):
    return value.detach().clone() if isinstance(value, torch.Tensor) else value


def _copy_all(value):
    """`_copy` through nested tuples (named ones keep their type) and lists."""
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_copy_all(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_copy_all(v) for v in value)
    if isinstance(value, dict):
        return {k: _copy_all(v) for k, v in value.items()}
    return _copy(value)


class KernelTap:
    def __init__(self, name: str):
        module, attr = ENTRIES[name]
        self.name, self.attr = name, attr
        self.defining = module
        self.original = getattr(importlib.import_module(module), attr)
        self.replacement: Optional[Callable] = None
        self.capturing = False
        self.stride = 1
        self.max_saved = 0
        self.saved: List[tuple] = []  # (args, kwargs, out), copies
        self.recording = False
        self.records: List[tuple] = []  # (args, kwargs) of the traced calls, not copied
        self.calls = 0
        self._patched: List[object] = []

    def __call__(self, *args, **kwargs):
        fn = self.original if self.replacement is None else self.replacement
        out = fn(*args, **kwargs)
        self.calls += 1
        if self.capturing:
            if self.calls % self.stride == 0 and len(self.saved) < self.max_saved:
                self.saved.append((tuple(_copy(a) for a in args),
                                   {k: _copy(v) for k, v in kwargs.items()}, _copy(out)))
        if self.recording:
            self.records.append((args, kwargs))
        return out

    def install(self) -> None:
        """Point every importer of the entry in the program at the tap."""
        for name, mod in list(sys.modules.items()):
            if mod is None or not (name == PROGRAM or name.startswith(PROGRAM + ".")):
                continue
            if name == self.defining:
                continue
            if getattr(mod, self.attr, None) is self.original:
                setattr(mod, self.attr, self)
                self._patched.append(mod)
        if not self._patched:
            raise RuntimeError(f"no module of the program calls {self.attr}")

    def uninstall(self) -> None:
        for mod in self._patched:
            setattr(mod, self.attr, self.original)
        self._patched = []


def install_taps() -> dict:
    """Import the program's entry modules and tap both kernels."""
    for mod in ("runtime.slam", "frontend.odometry", "mapping.backend", "voxel.knn",
                "voxel.voxelmap"):
        importlib.import_module(f"{PROGRAM}.{mod}")
    taps = {name: KernelTap(name) for name in ENTRIES}
    for tap in taps.values():
        tap.install()
    return taps


class StepTap:
    """`odometry.scan_step` through the tap; while `capturing`, each
    outermost call's arguments and result are copied into `saved`, up to
    `max_saved` (the unbatched call wraps a batched one)."""

    def __init__(self, max_saved: int):
        self.module = importlib.import_module(f"{PROGRAM}.frontend.odometry")
        self.attr = "scan_step"
        self.original = getattr(self.module, self.attr)
        self.capturing = False
        self.max_saved = max_saved
        self.saved: List[tuple] = []
        self._depth = 0
        setattr(self.module, self.attr, self)

    def __call__(self, *args, **kwargs):
        keep = self.capturing and self._depth == 0 and len(self.saved) < self.max_saved
        copied = (_copy_all(args), _copy_all(kwargs)) if keep else None
        self._depth += 1
        try:
            out = self.original(*args, **kwargs)
        finally:
            self._depth -= 1
        if keep:
            self.saved.append((*copied, _copy_all(out)))
        return out

    def uninstall(self) -> None:
        setattr(self.module, self.attr, self.original)

