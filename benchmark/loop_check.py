"""Compare the program's loop verification with the plain reference
(`reference/loop.py`, float64) on the card, candidate by candidate, in a
cell's own run. The benchmark's own runs do not do this (the stream driver
decides `correct` without it).

    python benchmark/loop_check.py --workload m2ud.stream --seeds 11,12,13 --seconds 51

Runs the cell through `drivers.run_cell` once a seed, one after the other
in one process, with a tap on `rolo_tpu_torch.loop.closure.verify_loop`
(put in the module's place for the run and taken out after it, as
`harness/capture.py`'s taps are) that keeps each call's operands: both
keyframes' rows, both assembled submaps, the initial yaw and the gate, and
the program's factor. After the run, for every candidate whose current
keyframe lies in the window:

- `loop_pose_gap_m`: whether the program's factor is a converged ICP
  solution. The reference's float64 ICP is started where the program's
  ended (the ICP pose the factor came from, `reference/loop.icp_pose_of`)
  and run to its own stop; the gap of its factor to the program's is the
  translations' distance plus `checks.LEVER_M` (30 m) times the rotations'
  angle (`checks.pose_gap`);
- `loop_fitness_rel_gap`: |program fitness - that reference's fitness| over
  the reference's;
- whether the program accepts or rejects as the reference run from the
  keyframes' own start (the yaw) does, and whether the reference's radius
  search picks the same candidate from the store's rows;
- for the record, with no tolerance: `cold_pose_gap_m` and
  `cold_fitness_rel_gap` to that reference from the yaw, and the iteration
  counts of the program's ICP and of both reference runs;
- the same gap for the bfloat16 reference's factor from the yaw (the
  control) and for the program's factor moved 1 cm along x (a fault), each
  against the float64 reference started where it puts the submap: both must
  exceed the tolerance.

Prints one JSON line a candidate and one a seed (`ok`: every candidate in
the window agrees on accept / reject and on the candidate, every accepted
factor within the tolerances, and at least one candidate was verified).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The program (float32) against the float64 reference started where the
# program's ICP ended. From the yaw the two end at fixed points up to mm
# apart, whether their iteration counts agree or not: the ICP re-fits from
# the original points and stops once a step moves every entry of the pose by
# under 1e-4 (1e-4 rad is 3 mm at the 30 m lever), and nearest neighbours
# that tie within float32's rounding pick other points in the two
# precisions. Restarted from the program's end the reference takes 1-4 more
# steps. 2 mm was set from the CPU fixture (seeds 0-7: 3.0e-6-4.6e-4 m)
# before the card's readings (PERF.md, section 2): 55 candidates read
# 5.1e-6-1.69e-3 m there, a 1 cm move of the factor 7.5e-3 m or more, the
# reference in bfloat16 8.2e-3 m or more.
TOLERANCES = {"loop_pose_gap_m": 2e-3, "loop_fitness_rel_gap": 1e-4}
NUDGE_M = 0.01


class VerifyTap:
    """`closure.verify_loop` through the tap: every call's operands, factor
    and ICP iteration count (the program's own counter, read from a tracer
    of the tap's own around the call), copied."""

    def __init__(self):
        self.module = importlib.import_module("rolo_tpu_torch.loop.closure")
        self.original = self.module.verify_loop
        self.saved = []
        self.module.verify_loop = self

    def __call__(self, db, cur_key, prev_key, cur_submap, prev_submap, init_yaw, **kwargs):
        from rolo_tpu_torch.runtime.profiling import StageTimers

        probe = StageTimers()
        probe.tracing = True
        with probe.stage("verify"):
            out = self.original(db, cur_key, prev_key, cur_submap, prev_submap, init_yaw,
                                **kwargs)
        cur, prev, n = int(cur_key), int(prev_key), int(db.count)
        self.saved.append({
            "cur": cur, "prev": prev, "cur_time": float(db.time[cur]),
            "rows": [t.detach().clone() for t in (db.rot[cur], db.trans[cur], db.rot[prev],
                                                 db.trans[prev])],
            "store": (db.trans[:n].detach().clone(), db.time[:n].detach().clone(), n),
            "submaps": [t.detach().clone() for t in (cur_submap.xyz, cur_submap.mask,
                                                    prev_submap.xyz, prev_submap.mask)],
            "yaw": float(init_yaw), "max_corr_dist": float(kwargs["max_corr_dist"]),
            "fitness_threshold": float(kwargs["fitness_threshold"]),
            "factor": (out.rel_rot.detach().clone(), out.rel_trans.detach().clone(),
                       float(out.noise_var[0]), bool(out.accepted)),
            "iterations": int(probe.summary()["verify.icp_iterations"]["total"])})
        return out

    def uninstall(self) -> None:
        self.module.verify_loop = self.original


def compare(call, radius: float, time_diff: float):
    """One candidate against the reference: its JSON row."""
    import torch

    from benchmark.harness.checks import pose_gap
    from benchmark.reference import loop as ref_loop

    args = (*call["rows"], *call["submaps"], call["yaw"], call["max_corr_dist"],
            call["fitness_threshold"])
    cold = ref_loop.verify(*args)
    control = ref_loop.verify(*args, dtype=torch.bfloat16)

    def settled(rel_rot, rel_trans):
        """The float64 reference's ICP from where a factor's ICP ended."""
        start = ref_loop.icp_pose_of(*call["rows"], rel_rot, rel_trans)
        return ref_loop.verify(*args, start=start)

    rot, trans, fitness, accepted = call["factor"]
    nudged = trans.clone()
    nudged[0] += NUDGE_M
    want, want_nudged = settled(rot, trans), settled(rot, nudged)
    want_control = settled(control.rel_rot, control.rel_trans)
    trans_s, time_s, n = call["store"]
    matched = torch.zeros(n, dtype=torch.bool, device=trans_s.device)
    return {
        "cur": call["cur"], "prev": call["prev"], "cur_time_s": call["cur_time"],
        "accepted": accepted, "reference_accepted": cold.accepted,
        "same_candidate": ref_loop.detect_radius(trans_s, time_s, n, matched, radius,
                                                 time_diff) == call["prev"],
        "fitness": fitness, "reference_fitness": want.fitness,
        "loop_pose_gap_m": float(pose_gap(rot, trans, want.rel_rot, want.rel_trans)),
        "loop_fitness_rel_gap": abs(fitness - want.variance) / want.variance,
        "cold_pose_gap_m": float(pose_gap(rot, trans, cold.rel_rot, cold.rel_trans)),
        "cold_fitness_rel_gap": abs(fitness - cold.variance) / cold.variance,
        "iterations": call["iterations"], "reference_iterations": cold.iterations,
        "settle_iterations": want.iterations,
        "bf16_pose_gap_m": float(pose_gap(control.rel_rot, control.rel_trans,
                                          want_control.rel_rot, want_control.rel_trans)),
        "bf16_accepted": control.accepted,
        "nudged_pose_gap_m": float(pose_gap(rot, nudged, want_nudged.rel_rot,
                                            want_nudged.rel_trans)),
    }


def judge(rows) -> bool:
    return bool(rows) and all(
        r["accepted"] == r["reference_accepted"] and r["same_candidate"]
        and (not r["accepted"] or all(r[k] <= v for k, v in TOLERANCES.items()))
        for r in rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="m2ud.stream")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("loop_check.py needs a CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import drivers, platform, spec

    platform.full_f32()
    cell = spec.load_cell(args.workload)
    loop = cell.config["pinned"]["loop"]
    window_from = cell.traffic["warmup_scans"] / cell.traffic["world"]["scan_rate_hz"]
    print(f"card: {platform.nvidia_smi_name_power()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        tap = VerifyTap()
        try:
            run = drivers.run_cell(cell, seed, args.seconds, False, "cuda", t0)
        finally:
            tap.uninstall()
        window = [c for c in tap.saved if c["cur_time"] >= window_from - 1e-6]
        rows = [compare(c, loop["history_search_radius"], loop["history_search_time_diff"])
                for c in window]
        for r in rows:
            print(json.dumps({"workload": cell.name, "seed": seed, **r}), flush=True)
        accepted = [r for r in rows if r["accepted"]]

        def worst(key, rs, pick=max):
            return pick((r[key] for r in rs), default=None)

        print(json.dumps({
            "workload": cell.name, "seed": seed, "ok": judge(rows), "correct": run["correct"],
            "candidates": len(rows), "warmup_candidates": len(tap.saved) - len(rows),
            "accepted": len(accepted),
            "agree": sum(r["accepted"] == r["reference_accepted"] for r in rows),
            "same_candidate": sum(r["same_candidate"] for r in rows),
            "max_loop_pose_gap_m": worst("loop_pose_gap_m", accepted),
            "max_loop_fitness_rel_gap": worst("loop_fitness_rel_gap", accepted),
            "max_cold_pose_gap_m": worst("cold_pose_gap_m", accepted),
            "min_bf16_pose_gap_m": worst("bf16_pose_gap_m", accepted, min),
            "min_nudged_pose_gap_m": worst("nudged_pose_gap_m", accepted, min),
            "tolerances": TOLERANCES, "scans_per_s": run["outcome"].end_to_end["scans_per_s"],
            "wall_s": time.perf_counter() - t0}), flush=True)
        del run, tap, window
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
