"""ctypes wrappers for the native host library `librolo_host`, the port's own
copy of `rolo_tpu/cpp/host.py`: PCD / KITTI decode, the indexed rosbag
reader and the background scan prefetch queue.

The library is built from the repo's `cpp/rolo_host.cpp` with g++ at first
use, into `build/rolo_tpu_torch/` at the root of the checkout, keyed by a
hash of the source and the flags (as `ops/cuda_build.py` keys the CUDA
kernels); a finished library is reused and nothing is written into `cpp/`.
Without a compiler, or when the build fails, every entry point raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
SRC = _REPO / "cpp" / "rolo_host.cpp"
BUILD_DIR = _REPO / "build" / "rolo_tpu_torch"
GXX_FLAGS = ("-O3", "-Wall", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for this source and these flags is (or will be)."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librolo_host-{digest}.so"


def build() -> Path:
    """Compile cpp/rolo_host.cpp unless a library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("librolo_host: g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"librolo_host: g++ failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))

        i64, i32 = ctypes.c_int64, ctypes.c_int32
        pf = ctypes.POINTER(ctypes.c_float)
        pi = ctypes.POINTER(ctypes.c_int32)
        pd = ctypes.POINTER(ctypes.c_double)
        vp = ctypes.c_void_p
        cs = ctypes.c_char_p

        lib.rolo_pcd_count.restype = i64
        lib.rolo_pcd_count.argtypes = [cs]
        lib.rolo_pcd_read.restype = i64
        lib.rolo_pcd_read.argtypes = [cs, pf, pf, pi, pf, i64]
        lib.rolo_kitti_read.restype = i64
        lib.rolo_kitti_read.argtypes = [cs, pf, i64]
        lib.rolo_bag_open.restype = vp
        lib.rolo_bag_open.argtypes = [cs]
        lib.rolo_bag_close.argtypes = [vp]
        lib.rolo_bag_num_connections.restype = i32
        lib.rolo_bag_num_connections.argtypes = [vp]
        lib.rolo_bag_connection_info.restype = i32
        lib.rolo_bag_connection_info.argtypes = [vp, i32, cs, i32, cs, i32]
        lib.rolo_bag_num_messages.restype = i64
        lib.rolo_bag_num_messages.argtypes = [vp]
        lib.rolo_bag_message_info.restype = i32
        lib.rolo_bag_message_info.argtypes = [vp, i64, pi, pd, ctypes.POINTER(i64)]
        lib.rolo_bag_read_odometry.restype = i32
        lib.rolo_bag_read_odometry.argtypes = [vp, i64, pd, pd, pd]
        lib.rolo_bag_read_pointcloud2.restype = i64
        lib.rolo_bag_read_pointcloud2.argtypes = [vp, i64, pd, pf, pf, pi, pf, i64]
        lib.rolo_queue_create.restype = vp
        lib.rolo_queue_create.argtypes = [ctypes.POINTER(cs), i64, i32, i64, i32]
        lib.rolo_queue_pop.restype = i64
        lib.rolo_queue_pop.argtypes = [vp, pf, pf, pi, pf, i64, ctypes.POINTER(i64)]
        lib.rolo_queue_destroy.argtypes = [vp]

        _lib = lib
        return _lib


def is_available() -> bool:
    """Whether the library builds and loads here (the tests' skip
    condition; the entry points below raise instead)."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def read_pcd_native(path: str) -> Dict[str, np.ndarray]:
    """PCD decode by the native library."""
    lib = _load()
    n = lib.rolo_pcd_count(path.encode())
    if n < 0:
        raise IOError(f"failed to read PCD: {path}")
    xyz = np.empty((n, 3), np.float32)
    intensity = np.empty((n,), np.float32)
    ring = np.empty((n,), np.int32)
    t = np.empty((n,), np.float32)
    got = lib.rolo_pcd_read(path.encode(), _fptr(xyz), _fptr(intensity), _iptr(ring), _fptr(t), n)
    if got < 0:
        raise IOError(f"failed to read PCD: {path}")
    return {"xyz": xyz[:got], "intensity": intensity[:got], "ring": ring[:got], "time": t[:got]}


def read_kitti_bin_native(path: str, max_points: int = 1 << 20) -> np.ndarray:
    lib = _load()
    buf = np.empty((max_points, 4), np.float32)
    n = lib.rolo_kitti_read(path.encode(), _fptr(buf), max_points)
    if n < 0:
        raise IOError(f"failed to read: {path}")
    return buf[:n].copy()


class BagReader:
    """Indexed rosbag V2.0 reader (uncompressed chunks) over the native
    parser: the replay path of the reference's bag-driven workflow."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._h = lib.rolo_bag_open(path.encode())
        if not self._h:
            raise IOError(f"failed to open bag: {path}")

    def close(self):
        if self._h:
            self._lib.rolo_bag_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def connections(self) -> List[Tuple[str, str]]:
        out = []
        for i in range(self._lib.rolo_bag_num_connections(self._h)):
            topic = ctypes.create_string_buffer(512)
            dtype = ctypes.create_string_buffer(256)
            self._lib.rolo_bag_connection_info(self._h, i, topic, 512, dtype, 256)
            out.append((topic.value.decode(), dtype.value.decode()))
        return out

    def __len__(self) -> int:
        return self._lib.rolo_bag_num_messages(self._h)

    def message_info(self, idx: int) -> Tuple[int, float, int]:
        conn = ctypes.c_int32()
        t = ctypes.c_double()
        size = ctypes.c_int64()
        rc = self._lib.rolo_bag_message_info(self._h, idx, ctypes.byref(conn), ctypes.byref(t),
                                             ctypes.byref(size))
        if rc != 0:
            raise IndexError(idx)
        return conn.value, t.value, size.value

    def read_odometry(self, idx: int) -> Dict[str, np.ndarray]:
        stamp = ctypes.c_double()
        pose = np.empty(7, np.float64)
        twist = np.empty(6, np.float64)
        rc = self._lib.rolo_bag_read_odometry(self._h, idx, ctypes.byref(stamp), _dptr(pose),
                                              _dptr(twist))
        if rc != 0:
            raise IOError(f"odometry parse failed at {idx}")
        return {"stamp": stamp.value, "position": pose[:3].copy(),
                "quat_xyzw": pose[3:].copy(), "twist": twist.copy()}

    def read_pointcloud2(self, idx: int, max_points: int = 1 << 20) -> Dict[str, np.ndarray]:
        stamp = ctypes.c_double()
        xyz = np.empty((max_points, 3), np.float32)
        intensity = np.empty((max_points,), np.float32)
        ring = np.empty((max_points,), np.int32)
        t = np.empty((max_points,), np.float32)
        n = self._lib.rolo_bag_read_pointcloud2(self._h, idx, ctypes.byref(stamp), _fptr(xyz),
                                                _fptr(intensity), _iptr(ring), _fptr(t),
                                                max_points)
        if n < 0:
            raise IOError(f"pointcloud2 parse failed at {idx}")
        return {"stamp": stamp.value, "xyz": xyz[:n].copy(), "intensity": intensity[:n].copy(),
                "ring": ring[:n].copy(), "time": t[:n].copy()}


class ScanPrefetchQueue:
    """Background-thread scan decoder: decodes `paths` ahead into a ring
    buffer so file IO overlaps the card's work."""

    FORMAT_PCD = 0
    FORMAT_KITTI = 1

    def __init__(self, paths: List[str], fmt: int = 0, capacity: int = 1 << 18, depth: int = 4):
        lib = _load()
        self._lib = lib
        self._capacity = capacity
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._h = lib.rolo_queue_create(arr, len(paths), fmt, capacity, depth)

    def pop(self) -> Optional[Dict[str, np.ndarray]]:
        """Next decoded scan, or None when exhausted."""
        cap = self._capacity
        xyz = np.empty((cap, 3), np.float32)
        intensity = np.empty((cap,), np.float32)
        ring = np.empty((cap,), np.int32)
        t = np.empty((cap,), np.float32)
        fidx = ctypes.c_int64()
        n = self._lib.rolo_queue_pop(self._h, _fptr(xyz), _fptr(intensity), _iptr(ring), _fptr(t),
                                     cap, ctypes.byref(fidx))
        if n < 0:
            return None
        return {"xyz": xyz[:n].copy(), "intensity": intensity[:n].copy(),
                "ring": ring[:n].copy(), "time": t[:n].copy(), "index": fidx.value}

    def close(self):
        if self._h:
            self._lib.rolo_queue_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
