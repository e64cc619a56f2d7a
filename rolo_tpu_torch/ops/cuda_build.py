"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles on its own with nvcc into a shared library
with a plain C interface, loaded through ctypes (no PyTorch headers, so a
build takes seconds). The build happens at first use, into
`build/rolo_tpu_torch/` at the root of the checkout, keyed by a hash of the
source and the flags; a finished library is reused.

Nothing here runs at import: the CPU tests import every module on a machine
with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "rolo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}  # name -> nvcc's output (-Xptxas -v: registers, spills)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Tuple[Path, float]:
    """Compile csrc/<name>.cu unless a library for this source exists.
    Returns (path, seconds spent compiling; 0.0 when reused)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    BUILD_LOG[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{BUILD_LOG[name]}")
    os.replace(tmp, out)
    return out, seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of csrc/<name>.cu with its argument types
    set, returning an int (a cudaError_t); prepared once per process."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn


def check_launch(rc: int, name: str) -> None:
    """Raise if the C entry point reported a non-zero cudaGetLastError()."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
