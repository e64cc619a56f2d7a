"""What a run can put in the program's place, to show that the check fails.
The benchmark's own runs use none of them; `control.py` and the tests do.

- `control`: both kernels computed by the plain reference in TF32, the
  precision below the full f32 the program states (it turns TF32 off);
- `tf32`: the program's own lower-precision path: TF32 matrix products,
  which its `configure_precision` turns off, left on;
- `control_features`: the feature extraction computed by the plain
  reference in bfloat16 (the program's f32 range image cast down, the
  feature clouds cast back);
- `fault_nudged@<m>`: the front-end's step translation moved <m> metres
  along x where produced (0.01 without a value): an error under the pose
  limits against the truth;
- `fault_state_unchanged`: the front-end step returns its state unchanged;
- `fault_answer_altered`: the back-end's mapped pose (its output, and the
  keyframe it stores) is moved 2 m up where it is produced;
- `fault_half_batch`: a batched front-end step advances only the first
  half of its sequences and leaves the rest as they were.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..reference import kernels as ref_kernels

VARIANTS = ("control", "tf32", "control_features", "fault_state_unchanged",
            "fault_answer_altered", "fault_half_batch", "fault_nudged")


def _control(taps) -> Callable[[], None]:
    taps["knn_moments"].replacement = (
        lambda xyz, mask, cand_xyz, cand_mask, xc, k: ref_kernels.knn_moments(
            xyz, mask, cand_xyz, cand_mask, xc, int(k), "tf32"))
    taps["keyed_sum"].replacement = (
        lambda values, keys_k, keys_m, keys_sorted=False, run_heads=False:
        ref_kernels.keyed_matmul(values, keys_k, keys_m, "tf32"))

    def undo():
        for tap in taps.values():
            tap.replacement = None
    return undo


def _tf32() -> Callable[[], None]:
    from rolo_tpu_torch.runtime import platform as prog_platform
    from rolo_tpu_torch.runtime import slam as slam_mod

    def allow_tf32() -> None:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")

    originals = (slam_mod.configure_precision, prog_platform.configure_precision)
    slam_mod.configure_precision = prog_platform.configure_precision = allow_tf32
    allow_tf32()

    def undo():
        slam_mod.configure_precision, prog_platform.configure_precision = originals
        from . import platform

        platform.full_f32()
    return undo


def _features_bf16() -> Callable[[], None]:
    from rolo_tpu_torch import bench as prog_bench
    from rolo_tpu_torch.pointcloud import features as prog_feats
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud

    from ..reference import featurize as ref_feat
    from ..reference import steps as ref_steps

    original = prog_feats.extract_features

    def extract_bf16(ring, *args, **kwargs):
        img = ref_feat.RingImage(*ref_steps.cast(tuple(ring), torch.bfloat16))
        fc = ref_feat.extract_features(img, *args, **kwargs)
        return prog_feats.FeatureClouds(
            *(PaddedCloud(c.xyz.to(torch.float32), c.mask) for c in fc))

    prog_feats.extract_features = prog_bench.extract_features = extract_bf16

    def undo():
        prog_feats.extract_features = prog_bench.extract_features = original
    return undo


def _nudged(metres: float) -> Callable[[], None]:
    from rolo_tpu_torch.frontend import odometry

    original = odometry.scan_step
    depth = [0]

    def step_nudged(state, *args, **kwargs):
        depth[0] += 1
        try:
            new_state, out = original(state, *args, **kwargs)
        finally:
            depth[0] -= 1
        if depth[0] > 0:  # the unbatched call's inner batched call
            return new_state, out
        d = torch.zeros_like(out.step_trans)
        d[..., 0] = metres
        # pose = pose_prev @ step^-1: a longer step moves the pose back by
        # pose_prev.rot @ step.rot^T @ d
        moved = out.pose_trans - torch.einsum("...ij,...kj,...k->...i", state.pose_rot,
                                              out.step_rot, d)
        new_state = new_state._replace(pose_trans=moved, step_trans=new_state.step_trans + d,
                                       trans_old=new_state.trans_old + d)
        return new_state, out._replace(pose_trans=moved, step_trans=out.step_trans + d)

    odometry.scan_step = step_nudged

    def undo():
        odometry.scan_step = original
    return undo


def _front_end_fault(kind: str) -> Callable[[], None]:
    from rolo_tpu_torch.frontend import odometry

    original = odometry.scan_step
    depth = [0]

    def faulty(state, new_xyz, *args, **kwargs):
        depth[0] += 1
        try:
            new_state, out = original(state, new_xyz, *args, **kwargs)
        finally:
            depth[0] -= 1
        if depth[0] > 0:  # the unbatched call's inner batched call
            return new_state, out
        if kind == "fault_state_unchanged":
            return state, out
        if new_xyz.dim() == 2:  # fault_half_batch: no batch to halve
            return new_state, out
        half = new_xyz.shape[0] // 2
        keep = torch.arange(new_xyz.shape[0], device=new_xyz.device) < half

        def mix(new, old):
            if new.dim() == 0:
                return new
            m = keep.reshape(-1, *([1] * (new.dim() - 1)))
            return torch.where(m, new, old.expand_as(new) if old.dim() else old)

        mixed = type(new_state)(*(mix(n, o) for n, o in zip(new_state, state)))
        out = out._replace(pose_rot=mixed.pose_rot, pose_trans=mixed.pose_trans)
        return mixed, out

    odometry.scan_step = faulty

    def undo():
        odometry.scan_step = original
    return undo


def _mapped_pose_lifted() -> Callable[[], None]:
    from rolo_tpu_torch.mapping import backend

    original = backend.backend_step

    def faulty(*args, **kwargs):
        state, out = original(*args, **kwargs)
        lift = torch.tensor([0.0, 0.0, 2.0], dtype=out.trans.dtype, device=out.trans.device)
        # the keyframe it stored, if any, is the same pose: lift that row too
        db = state.db
        rows = torch.arange(db.trans.shape[-2], device=db.trans.device)
        added = (rows == (db.count - 1)[..., None]) & out.keyframe_added[..., None]
        db = db._replace(trans=db.trans + added[..., None] * lift)
        return state._replace(db=db), out._replace(trans=out.trans + lift)

    backend.backend_step = faulty

    def undo():
        backend.backend_step = original
    return undo


def apply(variant: Optional[str], taps) -> Callable[[], None]:
    """Put `variant` in the program's place; returns the function that
    takes it out."""
    if variant is None:
        return lambda: None
    variant, _, value = variant.partition("@")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if variant == "control":
        return _control(taps)
    if variant == "tf32":
        return _tf32()
    if variant == "control_features":
        return _features_bf16()
    if variant == "fault_nudged":
        return _nudged(float(value) if value else 0.01)
    if variant == "fault_answer_altered":
        return _mapped_pose_lifted()
    return _front_end_fault(variant)
