"""Offline visualization exports, the port's copy of `rolo_tpu/runtime/viz.py`:
the headless stand-in for the reference's RViz publishers (global map, path,
loop markers, factor graph; backMapping.cpp:1341-1454, 1667-1900,
2626-2677).

Everything renders to files: PLY and JSON always, PNG only where matplotlib
is installed. The state is read from the card once per export, then
everything is numpy.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import so3
from ..geometry.se3 import rigid_align
from ..ops.pytree import tree_to_numpy


def _graph_host(slam):
    """(k, keyframe rot [k,3,3], trans [k,3], time [k], loops, priors) on the
    host; loops / priors as numpy dicts of the factor stores."""
    st = slam.backend_state
    k = int(st.db.count)
    return (k, st.db.rot[:k].cpu().numpy(), st.db.trans[:k].cpu().numpy(),
            st.db.time[:k].cpu().numpy(), tree_to_numpy(st.graph.loops),
            tree_to_numpy(st.graph.priors))


def _edges(f: dict):
    return [(int(f["i"][n]), int(f["j"][n])) for n in range(int(f["count"]))]


def write_ply(path: str, xyz: np.ndarray, color: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud (viewable in CloudCompare/MeshLab)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    has_c = color is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if has_c:
            c = np.asarray(color).reshape(-1, 3).astype(np.uint8)
            for p, rgb in zip(xyz, c):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {rgb[0]} {rgb[1]} {rgb[2]}\n")
        else:
            for p in xyz:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def write_ply_graph(path: str, nodes: np.ndarray, edges: Sequence[Tuple[int, int]],
                    edge_colors: Optional[Sequence[Tuple[int, int, int]]] = None) -> None:
    """ASCII PLY with vertex and edge elements: the pose graph as a
    wireframe (publishGlobalGraph's edge markers, backMapping.cpp:1667-1900)."""
    nodes = np.asarray(nodes, np.float32).reshape(-1, 3)
    edges = [(int(i), int(j)) for i, j in edges]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {nodes.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        if edge_colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in nodes:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        for k, (i, j) in enumerate(edges):
            if edge_colors is not None:
                r, g, b = edge_colors[k]
                f.write(f"{i} {j} {r} {g} {b}\n")
            else:
                f.write(f"{i} {j}\n")


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def render_factor_graph(slam, path: str) -> bool:
    """Top-down PNG of the pose graph: keyframes with heading axes, the
    odometry chain, loop edges (red) and prior factors (green). False when
    matplotlib is absent or the graph is empty."""
    plt = _pyplot()
    if plt is None:
        return False
    k, rot, pos, _, loops, priors = _graph_host(slam)
    if k == 0:
        return False
    fig, ax = plt.subplots(figsize=(9, 9))
    ax.plot(pos[:, 0], pos[:, 1], "-", color="0.6", linewidth=0.8, zorder=1,
            label="odometry chain")
    ax.scatter(pos[:, 0], pos[:, 1], s=8, c="tab:blue", zorder=3, label="keyframes")
    step = max(1, k // 60)  # at most ~60 axis glyphs
    hx = rot[::step, :, 0]
    ax.quiver(pos[::step, 0], pos[::step, 1], hx[:, 0], hx[:, 1], angles="xy", scale_units="xy",
              scale=0.8, width=0.003, color="tab:blue", alpha=0.6, zorder=2)
    for f, color, label in ((loops, "tab:red", "loop edges"),
                            (priors, "tab:green", "prior factors")):
        first = True
        for i, j in _edges(f):
            if i >= k or j >= k:
                continue
            ax.plot([pos[i, 0], pos[j, 0]], [pos[i, 1], pos[j, 1]], "--", color=color,
                    linewidth=1.2, alpha=0.85, zorder=4, label=label if first else None)
            first = False
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="best")
    ax.set_title(f"pose graph: {k} nodes, {int(loops['count'])} loops, "
                 f"{int(priors['count'])} priors")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_trajectory(path: str, trajectories: Sequence[Tuple[str, np.ndarray]],
                    loops: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
                    title: str = "trajectory") -> bool:
    """Top-down XY plot of trajectories with loop segments (the
    visualizeLoopClosure markers, backMapping.cpp:2626-2677). False when
    matplotlib is absent."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(8, 8))
    for name, pos in trajectories:
        pos = np.asarray(pos).reshape(-1, 3)
        ax.plot(pos[:, 0], pos[:, 1], label=name, linewidth=1.2)
        if len(pos):
            ax.scatter([pos[0, 0]], [pos[0, 1]], marker="^", s=40)
    for a, b in loops or ():
        ax.plot([a[0], b[0]], [a[1], b[1]], "r--", linewidth=0.8, alpha=0.7)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def export_factor_graph(slam, path: str) -> dict:
    """Factor-graph dump as JSON (publishGlobalGraph's node / edge / factor
    markers, backMapping.cpp:1667-1900): keyframe nodes (pose and stamp), the
    odometry chain, loop edges with noise and robust kernel, prior factors.
    Written to `path` and returned."""
    k, rot, trans, times, loops, priors = _graph_host(slam)
    quats = so3.matrix_to_quat(torch.as_tensor(rot)).numpy() if k else np.zeros((0, 4))
    nodes = [{"id": i, "time": float(times[i]), "xyz": trans[i].round(4).tolist(),
              "quat_wxyz": quats[i].round(5).tolist()} for i in range(k)]

    def edges_of(f):
        return [{"i": int(f["i"][n]), "j": int(f["j"][n]),
                 "noise_var": f["noise_var"][n].round(6).tolist(),
                 "robust_c": float(f["robust_c"][n])} for n in range(int(f["count"]))]

    graph = {
        "nodes": nodes,
        "odom_edges": [{"i": i - 1, "j": i} for i in range(1, k)],
        "loop_edges": edges_of(loops),
        "prior_factors": edges_of(priors),
        "drop_counts": dict(slam.drop_counts),
    }
    with open(path, "w") as f:
        json.dump(graph, f, indent=2)
    return graph


def export_prior_observability(slam, out_dir: str) -> int:
    """Every stored prior patch as one PLY (green) with its xy bounding
    boxes in prior_boxes.json (the reference's bounding-box and patch
    markers, backMapping.cpp:2253-2304). Returns the number of priors."""
    q = slam.backend_state.prior_queue
    n = int(min(int(q.count), q.capacity))
    masks = q.patch_mask[:n].cpu().numpy()
    xyz = q.patch_xyz[:n].cpu().numpy()
    linked = q.linked_key[:n].cpu().numpy()
    pts_all, boxes = [], []
    for i in range(n):
        pts = xyz[i][masks[i]]
        if not len(pts):
            continue
        pts_all.append(pts)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        boxes.append({"prior": i, "linked_key": int(linked[i]), "min": lo.round(3).tolist(),
                      "max": hi.round(3).tolist()})
    if pts_all:
        allp = np.concatenate(pts_all)
        color = np.tile(np.array([[60, 200, 60]], np.uint8), (len(allp), 1))
        write_ply(os.path.join(out_dir, "prior_patches.ply"), allp, color)
    with open(os.path.join(out_dir, "prior_boxes.json"), "w") as f:
        json.dump(boxes, f, indent=2)
    return n


def vehicle_outline(vehicle, rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Vehicle footprint polyline at a world pose (the mesh markers of
    prior_pose_node.cpp:238-286): a canonical box rigidly aligned to the
    wheel contact points (weighted Kabsch, ComputeRigidAlignment :29-64),
    closed into a loop."""
    wheels_b = vehicle.wheel_points_body.detach().cpu().float()  # [W, 3]
    canon = torch.tensor([[-0.5, 0.5, 0.0], [0.5, 0.5, 0.0], [0.5, -0.5, 0.0],
                          [-0.5, -0.5, 0.0]], dtype=torch.float32)[:wheels_b.shape[0]]
    body = rigid_align(canon, wheels_b).apply(canon).numpy()
    world = body @ np.asarray(rot).T + np.asarray(trans)
    return np.concatenate([world, world[:1]], axis=0)


def export_run(slam, out_dir: str) -> None:
    """One-call artifact dump for a SlamSystem: trajectory plot with loop
    segments, the global map as height-colored PLY, the factor graph (JSON,
    PLY, PNG), the prior patches and the vehicle outline."""
    os.makedirs(out_dir, exist_ok=True)
    st = slam.backend_state
    k, rot, trans, _, loops, priors = _graph_host(slam)
    trajs = []
    if slam.front_positions:
        trajs.append(("front-end", slam.front_positions_np()))
    if k:
        trajs.append(("keyframes", trans))
    segs = [(trans[i], trans[j]) for i, j in _edges(loops)]
    plot_trajectory(os.path.join(out_dir, "trajectory.png"), trajs, segs)

    surf_xyz = st.db.surf_xyz[:k].cpu().numpy()
    surf_mask = st.db.surf_mask[:k].cpu().numpy()
    clouds = [surf_xyz[i][surf_mask[i]] @ rot[i].T + trans[i] for i in range(k)]
    if clouds:
        pts = np.concatenate(clouds)
        z = pts[:, 2]
        zr = (z - z.min()) / max(float(z.max() - z.min()), 1e-6)
        color = np.stack([255 * zr, 64 + 0 * zr, 255 * (1 - zr)], axis=-1)
        write_ply(os.path.join(out_dir, "global_map.ply"), pts, color)

    export_factor_graph(slam, os.path.join(out_dir, "factor_graph.json"))
    render_factor_graph(slam, os.path.join(out_dir, "factor_graph.png"))
    if k:
        edges = [(i - 1, i) for i in range(1, k)]
        colors = [(150, 150, 150)] * len(edges)
        for f, col in ((loops, (220, 40, 40)), (priors, (40, 180, 60))):
            for i, j in _edges(f):
                if i < k and j < k:
                    edges.append((i, j))
                    colors.append(col)
        write_ply_graph(os.path.join(out_dir, "factor_graph.ply"), trans, edges, colors)
    export_prior_observability(slam, out_dir)
    if k:
        write_ply(os.path.join(out_dir, "vehicle_outline.ply"),
                  vehicle_outline(slam.vehicle, rot[k - 1], trans[k - 1]))
