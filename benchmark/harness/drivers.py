"""The two general drivers a traffic file names (`"driver"`), and the run
of one cell.

`stream`: one vehicle's live sensor. Scans are raycast in set-up and handed
to `SlamSystem.process_scan` as host arrays with the driver's ring and
per-point time fields, closed loop: the next scan goes in the moment the
previous scan's poses are on the host (`published()`).
The first `warmup_scans` run untimed on the same system; the window
continues the sequence.

`batch`: offline re-runs of a fleet's logs, `logs` sequences stepped one
scan index at a time: each scan copied to the card and featurized by the
program's `bench.featurize_parts`, one batched `scan_step` over the logs,
and one batched `backend_step` at the mapping cadence. When every log has
ended, a new job starts from fresh states on the same scans.

Both keep the poses the program publishes, the sampled scans' feature
clouds and front-end steps and the sampled kernel calls for the check, and
in a traced run profile a fixed sub-window.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import capture, checks, sim, stats, tracing
from ..roofline import keyed_sum as roof_k1
from ..roofline import knn_moments as roof_k2
from ..roofline import peaks


class Outcome(NamedTuple):
    end_to_end: Dict[str, float]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Dict]
    setup_s: float


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sample(rng: np.random.Generator, lo: int, span: int, n: int) -> List[int]:
    return sorted(int(x) for x in rng.choice(np.arange(lo, lo + span), size=n, replace=False))


def _stride(tap, units: int, calls_wanted: int, sampled_units: int) -> int:
    """Keep every stride-th call of the sampled units so that about
    `calls_wanted` are kept, from the calls per unit seen in warm-up."""
    per_unit = tap.calls / max(units, 1)
    return max(1, int(per_unit * sampled_units // max(calls_wanted, 1)))


def _rooflines(taps, kernel_s: Dict[str, float]) -> Dict[str, Optional[float]]:
    """Share (%) of the bound in the device time of each kernel family over
    the calls of the traced sub-window; None where it did not run."""
    bound = {"knn_moments": 0.0, "keyed_sum": 0.0}
    for args, _ in taps["knn_moments"].records:
        xyz, mask, cand_xyz, cand_mask, xc, k = args
        b, q, n, s = xyz.shape[0], xyz.shape[1], cand_xyz.shape[1], xc.shape[1]
        shared = xyz.data_ptr() == cand_xyz.data_ptr() and xyz.shape == cand_xyz.shape
        valid = int(mask.sum())
        bound["knn_moments"] += peaks.bound_s(roof_k2.flops(valid, int(k), s),
                                              roof_k2.nbytes(b, q, n, s, shared))
    for args, _ in taps["keyed_sum"].records:
        values, keys_k, keys_m = args[:3]
        b, s, k = values.shape
        m = keys_m.shape[1]
        shared = keys_k.data_ptr() == keys_m.data_ptr() and keys_k.shape == keys_m.shape
        bound["keyed_sum"] += peaks.bound_s(roof_k1.flops(b, s, k, m),
                                            roof_k1.nbytes(b, s, k, m, shared))
    return {name: (100.0 * bound[name] / kernel_s[name] if kernel_s[name] > 0 else None)
            for name in bound}


class _Profile:
    """The profiler over a fixed run of units (scans or scan indices)."""

    def __init__(self, taps, start: int, count: int, enabled: bool):
        self.taps, self.start, self.stop = taps, start, start + count
        self.enabled = enabled
        self._cm = None
        self.sink = None
        self.units = 0

    def before(self, unit: int) -> None:
        if self.enabled and unit == self.start:
            self._cm = tracing.profiled()
            self.sink = self._cm.__enter__()
            for tap in self.taps.values():
                tap.recording = True

    def after(self, unit: int) -> None:
        if self._cm is not None:
            self.units += 1
            if unit + 1 == self.stop:
                self.close()

    def active(self) -> bool:
        return self._cm is not None

    def close(self) -> None:
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
            self._cm = None
            for tap in self.taps.values():
                tap.recording = False

    def reduce(self) -> Optional[Dict]:
        if not self.sink:
            return None
        out = tracing.reduce_events(self.sink)
        out["units"] = self.units
        out["rooflines"] = _rooflines(self.taps, out["kernel_s"])
        self.sink = None
        for tap in self.taps.values():
            tap.records = []
        return out


def _start_capture(taps, on: bool) -> None:
    for tap in taps.values():
        tap.capturing = on


def _kernel_numbers(taps) -> Dict[str, float]:
    return {f"{name}_gap": checks.kernel_gap(name, tap.saved) for name, tap in taps.items()}


def _step_numbers(step, pinned: Dict) -> Dict[str, float]:
    gap = checks.frontend_step_gap(step.saved, pinned)
    step.saved = []
    return {"frontend_step_gap_m": gap}


def stream(ctx) -> Outcome:
    from rolo_tpu_torch.runtime import slam as slam_mod

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    world, sensor = tr["world"], ctx.config["sensor"]
    warmup = tr["warmup_scans"]
    n_total = warmup + int(round(world["scan_rate_hz"] * ctx.seconds))
    scans = sim.sequence(ctx.seed, sensor, world, n_total, dev)
    truth = sim.relative_truth(scans)
    rng = np.random.default_rng([ctx.seed, 1])
    check_at = set(_sample(rng, warmup, tr["check_from"], tr["check_scans"]))
    steps_at = check_at | {i + 1 for i in check_at}
    taps = ctx.taps

    # the sampled scans' feature clouds and deskew increments, from the
    # program's own calls inside process_scan
    feats_seen: List = []
    projection_args: List = []
    orig_project, orig_extract = slam_mod.project_scan, slam_mod.feats.extract_features
    capturing = [False]

    def project_tap(scan, *args, **kwargs):
        if capturing[0]:
            projection_args.append({k: v.detach().clone() for k, v in kwargs.items()
                                    if isinstance(v, torch.Tensor)})
        return orig_project(scan, *args, **kwargs)

    def extract_tap(*args, **kwargs):
        fc = orig_extract(*args, **kwargs)
        if capturing[0]:
            feats_seen.append(((fc.corners.xyz.clone(), fc.corners.mask.clone()),
                               (fc.surfaces.xyz.clone(), fc.surfaces.mask.clone())))
        return fc

    slam_mod.project_scan = project_tap
    slam_mod.feats.extract_features = extract_tap
    try:
        system = slam_mod.SlamSystem(cfg, dev)
        done, failed = 0, 0
        front, fused, mapped = {}, {}, {}

        def feed(i: int) -> None:
            s = scans[i]
            system.process_scan(s.xyz, s.stamp, ring=s.ring, rel_time=s.rel_time)
            pose = system.published()
            front[i] = pose["front_trans"]
            if bool(pose["fused_valid"]):
                fused[i] = pose["fused_trans"]
            if "mapped_trans" in pose:
                mapped[i] = pose["mapped_trans"]

        for i in range(warmup):
            feed(i)
        for tap in taps.values():
            tap.stride = _stride(tap, warmup, tr["kernel_calls_checked"], len(check_at))
            tap.max_saved = tr["kernel_calls_checked"]
        profile = _Profile(taps, warmup + tr["profile_from"], tr["profile_scans"], ctx.trace)
        if ctx.trace:
            system.sync_stages = True
        _sync(dev)
        system.timers.reset()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        t_win = time.perf_counter()
        setup_s = t_win - ctx.t_process
        t_end = t_win
        i = warmup
        while i < n_total and time.perf_counter() - t_win < ctx.seconds:
            profile.before(i)
            profiled = profile.active()
            counts = {k: len(v) for k, v in system.timers._samples.items()}
            sampled = i in check_at
            capturing[0] = sampled
            _start_capture(taps, sampled)
            ctx.step.capturing = i in steps_at
            feed(i)
            capturing[0] = False
            _start_capture(taps, False)
            ctx.step.capturing = False
            profile.after(i)
            if profiled:  # the profiler's cost is no stage's: drop the scan's samples
                for k, v in system.timers._samples.items():
                    del v[counts.get(k, 0):]
            t_end = time.perf_counter()
            done += 1
            if not np.isfinite(front[i]).all():
                failed += 1
            i += 1
        profile.close()
        _sync(dev)
        wall = t_end - t_win
        peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
        timers = system.timers.summary()
        _, kf_pos, _ = system.keyframe_trajectory()  # finalize(): the pending solve
        kf_t = system.backend_state.db.time[:kf_pos.shape[0]].cpu().numpy()
        del system
    finally:
        slam_mod.project_scan, slam_mod.feats.extract_features = orig_project, orig_extract
    trace = profile.reduce() if ctx.trace else None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    window = list(range(warmup, warmup + done))
    stamps = np.array([s.stamp for s in scans])
    ia, ib = stats.associate_by_time(kf_t, stamps)
    numbers = {
        "front_err_m": stats.max_position_error([front[i] for i in window], truth[window]),
        "fused_err_m": stats.max_position_error([fused[i] for i in window if i in fused],
                                                truth[[i for i in window if i in fused]]),
        "map_err_m": stats.max_position_error([mapped[i] for i in window if i in mapped],
                                              truth[[i for i in window if i in mapped]]),
        "keyframe_err_m": (stats.max_position_error(kf_pos[ia], truth[ib])
                           if len(ia) == len(kf_t) else float("inf")),
    }
    captured = []
    scans_checked = sorted(i for i in check_at if i < warmup + done)
    for j, i in enumerate(scans_checked):
        if j < len(feats_seen):
            deskew = projection_args[j] if j < len(projection_args) else None
            captured.append((scans[i], deskew or None, *feats_seen[j]))
    numbers["features_gap"] = checks.features_gap(captured, cfg, dev)
    numbers.update(_kernel_numbers(taps))
    numbers.update(_step_numbers(ctx.step, ctx.config["pinned"]))
    e2e = {"scans_per_s": done / wall if wall > 0 else 0.0}
    if trace is not None:
        trace["timers"] = timers
    return Outcome(e2e, numbers, done, failed, peak, trace, setup_s)


def _log_seed(seed: int, b: int) -> int:
    return int(np.random.SeedSequence([seed, b]).generate_state(1, np.uint64)[0] >> 1)


def batch(ctx) -> Outcome:
    from rolo_tpu_torch import bench as prog_bench
    from rolo_tpu_torch.frontend import odometry
    from rolo_tpu_torch.mapping import backend
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud, concat_clouds
    from rolo_tpu_torch.sim.dataset import SimFrame

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    world, sensor = tr["world"], ctx.config["sensor"]
    n_logs, n_idx = tr["logs"], tr["scans_per_log"]
    st, reg = cfg.static, cfg.registration
    logs = [sim.sequence(_log_seed(ctx.seed, b), sensor, world, n_idx, dev,
                         scene_seed=world["scene_seed"] + b) for b in range(n_logs)]
    truth = np.stack([sim.relative_truth(seq) for seq in logs])  # [L, T, 3]
    period = 1.0 / world["scan_rate_hz"]
    warmup = tr["warmup_indices"]
    rng = np.random.default_rng([ctx.seed, 1])
    c0 = _sample(rng, warmup, tr["check_from"], 1)[0]
    check_at = set(range(c0, c0 + tr["check_indices"]))
    taps = ctx.taps

    def featurize(scan):
        frame = SimFrame(scan.stamp, torch.from_numpy(scan.xyz).to(dev),
                         torch.from_numpy(scan.ring).to(dev),
                         torch.from_numpy(scan.rel_time).to(dev), None, None)
        return prog_bench.featurize_parts(frame, cfg)

    def stack(clouds):
        return PaddedCloud(torch.stack([c.xyz for c in clouds]),
                           torch.stack([c.mask for c in clouds]))

    spans = {"frontend": [], "backend": []}

    def span(name, fn):
        if not ctx.trace or profile.active():  # the profiler's cost is no layer's
            return fn()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        spans[name].append(time.perf_counter() - t0)
        return out

    job = {}
    finished = []  # each ended job's keyframe store (count, time, trans), copied on the card

    def new_job():
        if job:
            db = job["back"].db
            finished.append((db.count.clone(), db.time.clone(), db.trans.clone()))
        job["odom"] = odometry.init_state(st.max_feature_points, dev, batch=n_logs)
        job["back"] = backend.init_backend(cfg, dev, batch=n_logs)
        job["last_map"] = -math.inf

    front: List = []  # (index, [L, 3] device tensor)
    mapped: List = []
    feats_seen: List = []

    def step(i: int, sampled: bool) -> None:
        parts = [featurize(seq[i]) for seq in logs]
        if sampled:
            for b, (fc, _) in enumerate(parts):
                feats_seen.append((logs[b][i], None, (fc.corners.xyz, fc.corners.mask),
                                   (fc.surfaces.xyz, fc.surfaces.mask)))
        fcat = [concat_clouds(fc.corners, fc.surfaces, st.max_feature_points) for fc, _ in parts]
        xyz = torch.stack([c.xyz for c in fcat])
        mask = torch.stack([c.mask for c in fcat])
        job["odom"], out = span("frontend", lambda: odometry.scan_step(
            job["odom"], xyz, mask, period, reg, st.max_voxels, reg.k_correspondences,
            enable_failure_gate=reg.enable_failure_gate))
        front.append((i, out.pose_trans))
        stamp = i * period
        if stamp - job["last_map"] >= cfg.mapping.mapping_process_interval:
            job["last_map"] = stamp
            corner = stack([fc.corners for fc, _ in parts])
            surf = stack([fc.surfaces for fc, _ in parts])
            if cfg.loop.sc_input_type == "scan_raw":
                sc = stack([PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
                            for _, img in parts])
            else:
                sc = surf
            t = torch.full((n_logs,), stamp, dtype=torch.float32, device=dev)
            job["back"], mout = span("backend", lambda: backend.backend_step(
                job["back"], corner, surf, sc, out.pose_rot, out.pose_trans, True, t, cfg))
            mapped.append((i, mout.trans))

    profile = _Profile(taps, warmup + tr["profile_from"], tr["profile_indices"], ctx.trace)
    new_job()
    for i in range(warmup):
        step(i, False)
    for tap in taps.values():
        tap.stride = _stride(tap, warmup, tr["kernel_calls_checked"], len(check_at))
        tap.max_saved = tr["kernel_calls_checked"]
    for v in spans.values():
        v.clear()  # warm-up calls are no window's
    front.clear()
    mapped.clear()
    _sync(dev)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t_win = time.perf_counter()
    setup_s = t_win - ctx.t_process
    i, unit, done = warmup, warmup, 0
    while time.perf_counter() - t_win < ctx.seconds:
        if i == n_idx:
            new_job()
            i = 0
        profile.before(unit)
        sampled = unit in check_at
        _start_capture(taps, sampled)
        ctx.step.capturing = sampled
        step(i, sampled)
        _start_capture(taps, False)
        ctx.step.capturing = False
        profile.after(unit)
        i, unit, done = i + 1, unit + 1, done + 1
    profile.close()
    _sync(dev)
    wall = time.perf_counter() - t_win
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    db = job["back"].db
    kf = []
    for count, times, trans in finished + [(db.count, db.time, db.trans)]:
        counts = count.cpu().numpy()
        kf += [(times[b, :counts[b]].cpu().numpy(), trans[b, :counts[b]].cpu().numpy())
               for b in range(n_logs)]
    front_h = [(j, t.cpu().numpy()) for j, t in front]
    mapped_h = [(j, t.cpu().numpy()) for j, t in mapped]
    del job["back"], job["odom"], db, finished
    trace = profile.reduce() if ctx.trace else None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    failed = sum(int((~np.isfinite(t).all(axis=1)).sum()) for _, t in front_h)

    def err(rows):
        if not rows:
            return float("inf")
        est = np.concatenate([t for _, t in rows])
        want = np.concatenate([truth[:, j] for j, _ in rows])
        return stats.max_position_error(est, want)

    stamps = np.arange(n_idx) * period
    kf_err = 0.0
    for j, (kt, kp) in enumerate(kf):
        ia, ib = stats.associate_by_time(kt, stamps)
        kf_err = max(kf_err, stats.max_position_error(kp[ia], truth[j % n_logs, ib])
                     if len(ia) == len(kt) and len(kt) else float("inf"))
    numbers = {"front_err_m": err(front_h), "map_err_m": err(mapped_h), "keyframe_err_m": kf_err,
               "features_gap": checks.features_gap(feats_seen, cfg, dev)}
    numbers.update(_kernel_numbers(taps))
    numbers.update(_step_numbers(ctx.step, ctx.config["pinned"]))
    e2e = {"batch_scans_per_s": n_logs * done / wall if wall > 0 else 0.0}
    if trace is not None:
        trace["spans"] = {k: {"count": len(v), "mean_ms": 1e3 * float(np.mean(v))}
                          for k, v in spans.items() if v}
    return Outcome(e2e, numbers, n_logs * done, failed, peak, trace, setup_s)


DRIVERS = {"stream": stream, "batch": batch}


class Context(NamedTuple):
    cell: object
    config: Dict
    traffic: Dict
    cfg: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    taps: Dict
    step: object
    t_process: float


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_process: float,
             variant: Optional[str] = None) -> Dict:
    """One run of `cell`: set-up, window, check. Returns the result's
    fields (without `device`'s name and count, which the caller adds)."""
    from . import spec, variants

    cfg = spec.resolve_config(cell.config)
    pin = spec.pin_mismatches(cfg, cell.config["pinned"])
    taps = capture.install_taps()
    undo = variants.apply(variant, taps)
    step = capture.StepTap(cell.traffic["steps_checked"])
    try:
        ctx = Context(cell, cell.config, cell.traffic, cfg, int(seed), float(seconds), bool(trace),
                      torch.device(device), taps, step, t_process)
        out = DRIVERS[cell.traffic["driver"]](ctx)
    finally:
        step.uninstall()
        undo()
        for tap in taps.values():
            tap.uninstall()
    numbers = {"pin_mismatches": float(len(pin)), **out.numbers}
    return {"outcome": out, "numbers": numbers, "pin": pin,
            "correct": checks.judge(numbers, cell.limits)}
