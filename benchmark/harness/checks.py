"""The comparisons that decide `correct`, run once the window has closed.

Each number is compared with its limit from `limits/<cell>.json`:

- `pin_mismatches`: fields where the resolved RoloConfig departs from the
  configuration file's pin (limit 0);
- `features_gap`: for the sampled scans, the share of feature points
  (corners, surfaces) that the program produced and the plain reference
  (`reference/featurize.py` in float64, from the raw scan the benchmark
  handed over) did not, or the other way round, within 1 mm;
- `frontend_step_gap_m`: for the sampled front-end steps, the largest gap
  between the program's step and the plain reference's
  (`reference/steps`, float64) on the same inputs: the translations'
  distance plus `LEVER_M` times the rotations' angle (how far apart the two
  steps put a point that far from the sensor);
- `knn_moments_gap`, `keyed_sum_gap`: over the sampled kernel calls, the
  largest difference between the program's output and the plain
  reference's (`reference/kernels.py`, full f32) on the same operands, as a
  share of the largest magnitude in that output plane;
- `*_err_m`: the largest distance between a pose the program produced and
  the simulator's ground truth, in the first scan's frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..reference import featurize as ref_feat
from ..reference import kernels as ref_kernels
from ..reference import steps as ref_steps

MATCH_M = 1e-3
LEVER_M = 30.0
REFERENCE_DTYPE = torch.float64


def _unmatched(a: torch.Tensor, b: torch.Tensor, chunk: int = 2048) -> int:
    """Points of a [P, 3] with no point of b [R, 3] within MATCH_M."""
    if a.shape[0] == 0:
        return 0
    if b.shape[0] == 0:
        return a.shape[0]
    n = 0
    for i in range(0, a.shape[0], chunk):
        d = torch.cdist(a[i:i + chunk].double(), b.double()).amin(dim=1)
        n += int((d > MATCH_M).sum())
    return n


def cloud_gap(got_xyz, got_mask, want_xyz, want_mask) -> float:
    a, b = got_xyz[got_mask.bool()], want_xyz[want_mask.bool()]
    return (_unmatched(a, b) + _unmatched(b, a)) / max(b.shape[0], 1)


def reference_features(scan, cfg, device, deskew: Optional[Dict] = None,
                       dtype: torch.dtype = REFERENCE_DTYPE):
    """The plain reference's feature clouds of a raw scan (host arrays), as
    the program's ingest pads it to `max_raw_points`, computed in `dtype`."""
    st, s = cfg.static, cfg.sensor
    cap = st.max_raw_points
    m = min(scan.xyz.shape[0], cap)
    with ref_steps.default_dtype(dtype):
        xyz = torch.zeros(cap, 3, device=device)
        ring = torch.zeros(cap, dtype=torch.int32, device=device)
        rel = torch.zeros(cap, device=device)
        xyz[:m] = torch.as_tensor(scan.xyz[:m], device=device)
        ring[:m] = torch.as_tensor(scan.ring[:m], device=device)
        rel[:m] = torch.as_tensor(scan.rel_time[:m], device=device)
        raw = ref_feat.RawScan(xyz, ring, rel, torch.arange(cap, device=device) < m)
        img = ref_feat.project_scan(raw, s.n_scan, s.horizon_scan, s.lidar_min_range,
                                    s.lidar_max_range, s.downsample_rate,
                                    **ref_steps.cast(deskew or {}, dtype))
        f = cfg.features
        return ref_feat.extract_features(img, f.edge_threshold, f.surf_threshold,
                                         f.odometry_surf_leaf_size, st.max_corner_points,
                                         st.max_surf_points)


def features_gap(captured: List, cfg, device) -> float:
    """captured: (scan, deskew kwargs or None, program corners, program
    surfaces) per sampled scan, each cloud an (xyz, mask) pair."""
    if not captured:
        return float("inf")
    worst = 0.0
    for scan, deskew, corners, surfaces in captured:
        ref = reference_features(scan, cfg, device, deskew)
        worst = max(worst, cloud_gap(*corners, ref.corners.xyz, ref.corners.mask),
                    cloud_gap(*surfaces, ref.surfaces.xyz, ref.surfaces.mask))
    return worst


def pose_gap(rot_a, trans_a, rot_b, trans_b) -> torch.Tensor:
    """Per instance: |trans_a - trans_b| + LEVER_M x the angle between
    rot_a and rot_b (from the Frobenius distance, exact near zero)."""
    dt = torch.linalg.vector_norm(trans_a.double() - trans_b.double(), dim=-1)
    fro = torch.linalg.vector_norm((rot_a.double() - rot_b.double()).flatten(-2), dim=-1)
    angle = 2.0 * torch.asin(torch.clamp(fro / (2.0 * 2.0 ** 0.5), max=1.0))
    return (dt + LEVER_M * angle).reshape(-1)


def frontend_step_gap(saved: List, pinned: Dict) -> float:
    """saved: (args, kwargs, output) of the program's `scan_step` calls; the
    largest over every sequence of every call. +inf when none was saved."""
    if not saved:
        return float("inf")
    reg = ref_steps.registration_config(pinned["registration"])
    gaps = []
    for args, _, (_, out) in saved:
        state, xyz, mask, interval = args[:4]
        rot, trans = ref_steps.frontend_step(state, xyz, mask, interval, reg,
                                             pinned["static"]["max_voxels"],
                                             reg.k_correspondences, reg.enable_failure_gate,
                                             REFERENCE_DTYPE)
        gaps.append(pose_gap(out.step_rot, out.step_trans, rot, trans))
    return float(torch.cat(gaps).max())


def output_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over [B, S, M] as a share of the largest |want|
    in the same plane s."""
    scale = want.abs().amax(dim=(0, 2)).double()
    err = (got.double() - want.double()).abs().amax(dim=(0, 2))
    share = torch.where(scale > 0, err / scale.clamp(min=1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(share.max()) if share.numel() else 0.0


def reference_call(name: str, args, kwargs, precision: str = "highest") -> torch.Tensor:
    if name == "knn_moments":
        xyz, mask, cand_xyz, cand_mask, xc, k = args
        return ref_kernels.knn_moments(xyz, mask, cand_xyz, cand_mask, xc, int(k), precision)
    values, keys_k, keys_m = args[:3]
    return ref_kernels.keyed_matmul(values, keys_k, keys_m, precision)


def kernel_gap(name: str, saved: List) -> float:
    """The worst `output_gap` over the saved calls of one kernel; +inf when
    no call was saved (the kernel did not run where the check looked)."""
    if not saved:
        return float("inf")
    worst = 0.0
    for args, kwargs, out in saved:
        worst = max(worst, output_gap(out, reference_call(name, args, kwargs)))
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number limited and within its limit (a missing one fails)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)
