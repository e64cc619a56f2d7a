"""Host-side IO: PCD read/write, KITTI velodyne .bin, TUM trajectory and g2o
pose-graph export, and state checkpoints; the port's own copy of
`rolo_tpu/runtime/io.py`.

The exporters are the reference's end-of-run writers (backMapping.cpp:
saveTUM :2679-2699, writeG2OVertex/writeG2OEdge :1480-1498, saveGlobalPCDs
:1500-1608) in numpy; tensors never reach this layer except through the
checkpoint functions.

A checkpoint is one `.npz` in the JAX package's layout: `leaf_{i}` in JAX's
flatten order of the saved tuple of states (field order, depth first, None
dropped), each leaf int32 / f32 / bool as the JAX package stores it, an f64
`host_meta` array beside them, and a `treedef` string that neither loader
reads. A checkpoint written by either package restores in the other.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pytree import tree_leaves, tree_replace_leaves

# ---------------------------------------------------------------------------
# PCD
# ---------------------------------------------------------------------------

_PCD_DTYPES = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
               ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Read an ascii or binary PCD file into named field arrays.

    Supports the fields the reference's point types use (utility.h:68-95:
    x y z intensity ring time / t). Returns {field: [N] array}.
    """
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key.upper()] = rest.split()
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0].lower()

        np_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = _PCD_DTYPES[(typ, size)]
            np_fields.append((name, base) if cnt == 1 else (name, base, (cnt,)))
        dtype = np.dtype(np_fields)

        if mode == "ascii":
            body = np.loadtxt(f, dtype=np.float64, ndmin=2)
            out = {}
            col = 0
            for name, size, typ, cnt in zip(fields, sizes, types, counts):
                base = _PCD_DTYPES[(typ, size)]
                block = body[:, col:col + cnt].astype(base)
                out[name] = block.squeeze(-1) if cnt == 1 else block
                col += cnt
            return out
        if mode == "binary":
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            return {name: np.ascontiguousarray(raw[name]) for name in dtype.names}
        raise ValueError(f"unsupported PCD DATA mode: {mode} (binary_compressed not supported)")


def write_pcd(path: str, xyz: np.ndarray, intensity: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    """Write [N, 3] points (+ optional intensity) as PCD (pcl::io::savePCDFile
    as saveGlobalPCDs uses it, backMapping.cpp:1543-1557)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    fields = "x y z" + (" intensity" if intensity is not None else "")
    nf = 4 if intensity is not None else 3
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {' '.join(['4'] * nf)}\n"
        f"TYPE {' '.join(['F'] * nf)}\n"
        f"COUNT {' '.join(['1'] * nf)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = xyz if intensity is None else np.column_stack([xyz, np.asarray(intensity, np.float32)])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(data, np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: [N, 4] (x, y, z, intensity) float32."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------

def write_tum(path: str, times: Sequence[float], positions: np.ndarray,
              quats_wxyz: np.ndarray) -> None:
    """TUM format `t x y z qx qy qz qw` (saveTUM, backMapping.cpp:2679-2699)."""
    positions = np.asarray(positions).reshape(-1, 3)
    q = np.asarray(quats_wxyz).reshape(-1, 4)
    with open(path, "w") as f:
        for t, p, (w, x, y, z) in zip(times, positions, q):
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {x:.6f} {y:.6f} {z:.6f} {w:.6f}\n")


def read_tum(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (times [N], positions [N,3], quats_wxyz [N,4])."""
    rows = np.loadtxt(path, ndmin=2)
    t = rows[:, 0]
    pos = rows[:, 1:4]
    qxyzw = rows[:, 4:8]
    quat = np.column_stack([qxyzw[:, 3], qxyzw[:, 0], qxyzw[:, 1], qxyzw[:, 2]])
    return t, pos, quat


def write_g2o(
    path: str,
    positions: np.ndarray,
    quats_wxyz: np.ndarray,
    odom_edges: Sequence[Tuple[int, int, np.ndarray, np.ndarray]],
    loop_edges: Sequence[Tuple[int, int, np.ndarray, np.ndarray]] = (),
    prior_edges: Sequence[Tuple[int, int, np.ndarray, np.ndarray]] = (),
) -> None:
    """g2o export (writeG2OVertex/writeG2OEdge, backMapping.cpp:1480-1498,
    invoked at :1559-1605): VERTEX_SE3:QUAT lines then EDGE_SE3:QUAT with
    identity information (the reference writes the identity upper
    triangle). Edges are (i, j, rel_pos [3], rel_quat_wxyz [4])."""
    positions = np.asarray(positions).reshape(-1, 3)
    q = np.asarray(quats_wxyz).reshape(-1, 4)
    info = " ".join(["1 0 0 0 0 0", "1 0 0 0 0", "1 0 0 0", "1 0 0", "1 0", "1"])
    with open(path, "w") as f:
        for i, (p, (w, x, y, z)) in enumerate(zip(positions, q)):
            f.write(f"VERTEX_SE3:QUAT {i} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{x:.6f} {y:.6f} {z:.6f} {w:.6f}\n")
        for edges in (odom_edges, loop_edges, prior_edges):
            for i, j, rp, rq in edges:
                w, x, y, z = rq
                f.write(f"EDGE_SE3:QUAT {i} {j} {rp[0]:.6f} {rp[1]:.6f} {rp[2]:.6f} "
                        f"{x:.6f} {y:.6f} {z:.6f} {w:.6f} {info}\n")


# ---------------------------------------------------------------------------
# Checkpoints (the states as the resume unit)
# ---------------------------------------------------------------------------

def _stored(leaf) -> np.ndarray:
    """A leaf as the JAX package stores it: f32, int32 or bool."""
    a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    if a.dtype == np.bool_:
        return a
    return a.astype(np.float32 if a.dtype.kind == "f" else np.int32)


def save_checkpoint(path: str, tree, host_meta: np.ndarray = None) -> None:
    """Serialize a tuple / NamedTuple tree of tensors to one `.npz` file.
    `host_meta` (an optional f64 array) is stored as given: UNIX-epoch
    stamps need f64."""
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _stored(leaf) for i, leaf in enumerate(leaves)}
    if host_meta is not None:
        arrays["host_meta"] = np.asarray(host_meta, np.float64)
    treedef = "rolo_tpu_torch:" + ",".join(f"{tuple(leaf.shape)}" for leaf in leaves)
    np.savez_compressed(path, treedef=treedef, **arrays)


def load_checkpoint(path: str, example_tree, with_host_meta: bool = False):
    """Restore a tree saved by `save_checkpoint` (or by the JAX package) into
    the structure of `example_tree`: each leaf with the example's shape,
    dtype and device. With `with_host_meta`, returns (tree, host_meta or
    None)."""
    data = np.load(path, allow_pickle=False)
    leaves = tree_leaves(example_tree)
    stored = sum(1 for name in data.files if name.startswith("leaf_"))
    if stored != len(leaves):
        raise ValueError(f"{path}: {stored} leaves stored, the state has {len(leaves)}")
    restored = []
    for i, ex in enumerate(leaves):
        a = data[f"leaf_{i}"]
        if tuple(a.shape) != tuple(ex.shape):
            raise ValueError(f"{path}: leaf_{i} has shape {a.shape}, the state {tuple(ex.shape)}")
        restored.append(torch.as_tensor(a).to(dtype=ex.dtype, device=ex.device))
    tree = tree_replace_leaves(example_tree, iter(restored))
    if with_host_meta:
        return tree, (data["host_meta"] if "host_meta" in data.files else None)
    return tree
