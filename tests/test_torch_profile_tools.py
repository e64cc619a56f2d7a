"""The port's stage profilers and diagnostics (tools/torch_profile_*.py,
tools/torch_diag_*.py) on the CPU, at the bag fixture's capacities: their
stage, row and variant names are the reference tools', read from their
source with `ast`; on the same seeded inputs the front-end profiler's
iteration counts, the CT variants' estimates and the solve diagnostics'
solutions agree with the JAX package's; the prior diagnostic's funnels
narrow gate by gate and end at the run's prior factors; and every tool
refuses to run without a card. The reference tools are loaded by file.
No time is checked: these run on the CPU."""

import ast
import dataclasses
import functools
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import REPO, jax_config, rot_err_deg, small_config, small_sim_kwargs

TOOLS = os.path.join(REPO, "tools")
PROFILERS = ("torch_profile_frontend", "torch_profile_stages", "torch_profile_build",
             "torch_profile_backend", "torch_profile_projection")
DIAGNOSTICS = ("torch_diag_dense_solve", "torch_diag_graphsolve", "torch_diag_ct",
               "torch_diag_prior")
# tests/test_torch_frontend.py's pose agreement
POSE_ROT_DEG = 0.1
POSE_TRANS_M = 0.01
POSE_TOL = 2e-4  # tests/test_torch_graph.py


@functools.lru_cache(maxsize=None)
def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  os.path.join(TOOLS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _tree(name):
    return ast.parse(open(os.path.join(TOOLS, f"{name}.py")).read())


def _call_names(name, fn):
    """The first arguments of the reference tool's calls of `fn`: a string,
    or an f-string as a regex with `.+` for each formatted value."""
    out = []
    for node in ast.walk(_tree(name)):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == fn and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append(re.escape(arg.value))
        elif isinstance(arg, ast.JoinedStr):
            out.append("".join(re.escape(v.value) if isinstance(v, ast.Constant) else ".+"
                               for v in arg.values))
    return out


def _subscript_keys(name, var):
    """The string keys the reference tool writes as var["..."]."""
    return {node.slice.value for node in ast.walk(_tree(name))
            if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
            and node.value.id == var and isinstance(node.slice, ast.Constant)}


def _match(templates, names):
    """Each name matches a template and each template some name."""
    return (all(any(re.fullmatch(t, n) for t in templates) for n in names)
            and all(any(re.fullmatch(t, n) for n in names) for t in templates))


# ------------------------------------------------------- names of the reports


def test_profiler_stage_names_are_the_reference_tools():
    assert set(_load("torch_profile_frontend").STAGES) == _subscript_keys("profile_frontend",
                                                                          "rows")
    for port, ref in (("torch_profile_stages", "profile_stages"),
                      ("torch_profile_backend", "profile_backend"),
                      ("torch_profile_projection", "profile_projection")):
        assert sorted(_load(port).STAGES) == sorted(
            re.sub(r"\\(.)", r"\1", t) for t in _call_names(ref, "timeit")), port


def test_diagnostic_names_are_the_reference_tools():
    tree = _tree("diag_dense_solve")
    ms = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
          for tgt in node.targets if isinstance(tgt, ast.Tuple)
          for t in tgt.elts if isinstance(t, ast.Name) and t.id.startswith("ms_")}
    row, _, _ = _load("torch_diag_dense_solve").decompose(32, "cpu", reps=1)
    assert {k for k in row if k.startswith("ms_")} == ms
    loops = [node.iter for node in ast.walk(_tree("diag_graphsolve"))
             if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple)]
    consts = [tuple(e.value for e in it.elts) for it in loops]
    graphsolve = _load("torch_diag_graphsolve")
    assert set(consts) == {graphsolve.BUCKETS, graphsolve.METHODS}
    # diag_ct: its docstring's variants A-F and its main's four
    ct = _load("torch_diag_ct")
    ref_doc = ast.get_docstring(_tree("diag_ct"))
    letters = set(re.findall(r"^  ([A-Z])  ", ref_doc, re.M))
    ref_names = {e.elts[0].value for node in ast.walk(_tree("diag_ct"))
                 if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") ==
                 "variants" for e in node.value.elts}
    names = [v[0] for v in ct.VARIANTS]
    assert ref_names <= set(names)
    assert {n[0] for n in names} == letters | {n[0] for n in ref_names}
    # diag_prior: the reference's counters, the solver's failure gates too
    prior = _load("torch_diag_prior")
    gates = {e.elts[0].value for node in ast.walk(_tree("diag_prior"))
             if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple)
             for e in node.iter.elts if isinstance(e, ast.Tuple)}
    assert (set(prior.RECORD_FUNNEL) | set(prior.ASSOCIATE_FUNNEL)
            | set(prior.SOLVER_FAILURES)) == _subscript_keys("diag_prior", "stats") | gates


# ------------------------------------------------------------- the profilers


def test_frontend_profile_matches_reference_iterations():
    """torch_profile_frontend's ring cloud at the fixture's 1,536 feature
    slots (1,000 valid) and 4,096 voxels: its ten rows, and the rotation
    and CT iteration counts of profile_frontend.py's calls in JAX."""
    from rolo_tpu.registration import gicp, lm
    from rolo_tpu.voxel.knn import estimate_cov6
    from rolo_tpu.voxel.voxelmap import build_voxel_map

    tool = _load("torch_profile_frontend")
    n, valid = 1536, 1000
    report = tool.profile("cpu", small_config(), n=n, valid=valid, iters=1)
    assert list(report["stages"]) == list(tool.STAGES)
    assert all(np.isfinite(r["wall_ms"]) and "kernel_ms" not in r
               for r in report["stages"].values())
    jcfg = jax_config()
    rc, cap = jcfg.registration, jcfg.static.max_voxels
    src, tgt, mask = (jnp.asarray(a) for a in tool.ring_cloud(n, valid))
    polar = jnp.asarray(rc.polar_resolution, jnp.float32)
    dt = jnp.asarray(0.1, jnp.float32)

    def cov(x):
        return estimate_cov6(x, mask, k=rc.k_correspondences, method=rc.regularization)

    vmap = build_voxel_map(tgt, cov(tgt), mask, cap, polar_res=polar,
                           resolution=rc.voxel_resolution)
    ctx = gicp.make_context(src, mask, cov(src), vmap, polar_res=polar,
                            resolution=rc.voxel_resolution, neighbor_search=rc.neighbor_search)
    rot = lm.lm_register_rotation(
        ctx, jnp.eye(3), jnp.zeros(3), max_outer=rc.max_outer_iterations,
        max_inner=rc.lm_max_inner_iterations, rot_eps=rc.rotation_epsilon,
        trans_eps=rc.transformation_epsilon, init_lambda_factor=rc.lm_init_lambda_factor)
    ct = lm.lm_translation_rebind(
        ctx, jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.zeros(3), dt, dt, rc.ct_lambda,
        rebind_rounds=min(rc.ct_rebind_rounds, 2), max_outer=min(rc.max_outer_iterations, 16),
        max_inner=rc.lm_max_inner_iterations, trans_eps=rc.transformation_epsilon,
        init_lambda_factor=rc.lm_init_lambda_factor)
    assert report["rotation_iterations"] == int(rot.iterations) > 0
    assert report["ct_iterations"] == int(ct.iterations) > 0


def test_stage_build_backend_and_projection_profiles_run():
    """Each profiler's rows at small shapes, every row's wall time finite."""
    from rolo_tpu_torch.sim import SimConfig

    cfg = small_config()
    stages = _load("torch_profile_stages").profile("cpu", batch=2, n=256, cap=512, iters=1,
                                                   cfg=cfg.registration)
    build = _load("torch_profile_build").profile("cpu", batch=2, n=256, iters=1)
    backend = _load("torch_profile_backend").profile("cpu", cfg, n_kf=4, iters=1,
                                                     raw_points=3000, raw_cap=4096)
    proj = _load("torch_profile_projection").profile(
        "cpu", cfg, SimConfig(n_scans=1, n_cols=512, sensor="velodyne16", seed=0), iters=1)
    for name, report in (("torch_profile_stages", stages), ("torch_profile_backend", backend),
                         ("torch_profile_projection", proj)):
        assert list(report["stages"]) == list(_load(name).STAGES), name
        assert all(np.isfinite(r["wall_ms"]) for r in report["stages"].values()), name
    assert len(stages["rotation_iterations"]) == 2 and backend["shapes"]["keyframes"] == 4
    assert proj["counts"]["features"] > 0
    assert _match(_call_names("profile_build", "chain_time"), build["rows"])
    assert all(np.isfinite(r["ms"]) and "device_ms" not in r for r in build["rows"].values())


# ------------------------------------------------------------ the diagnostics


@functools.lru_cache(maxsize=None)
def _ct_pairs():
    from rolo_tpu_torch.sim import SimConfig

    ct = _load("torch_diag_ct")
    return ct.workload(2, "cpu", small_config(), SimConfig(**small_sim_kwargs(6)))


@functools.lru_cache(maxsize=None)
def _jax_variant(changes, rotated, kw):
    """diag_ct.py's register_variant vmapped and jitted; variants that
    differ only in their inputs (E and F: the previous step) share one."""
    ref, jcfg = _load("diag_ct"), jax_config()
    reg = dataclasses.replace(jcfg.registration, **dict(changes))
    return jax.jit(jax.vmap(lambda s, sm, t, tm, g, lt, d: ref.register_variant(
        s, sm, t, tm, g, lt, d, reg, jcfg.static.max_voxels, 20, rotated, **dict(kw))))


@pytest.mark.parametrize("variant", [v[0] for v in _load("torch_diag_ct").VARIANTS])
def test_ct_variant_matches_reference(variant):
    """Each variant's estimates on two fixture-size pairs against
    diag_ct.py's register_variant, vmapped in JAX, on the same arrays."""
    port = _load("torch_diag_ct")
    spec = next(v for v in port.VARIANTS if v[0] == variant)
    _, changes, rotated, true_last, kw = spec
    cfg = small_config()
    pairs = _ct_pairs()
    row = port.run_variants(pairs, cfg.registration, cfg.static.max_voxels,
                            variants=[spec])[variant]
    src, src_mask, tgt, tgt_mask, _, _, last = (jnp.asarray(p.numpy()) for p in pairs)
    zero = jnp.zeros_like(last)
    fn = _jax_variant(tuple(changes.items()), rotated, tuple(kw.items()))
    rot, trans = (np.asarray(a) for a in fn(src, src_mask, tgt, tgt_mask, zero,
                                            last if true_last else zero, jnp.full((2,), 0.2)))
    assert np.isfinite(row["trans"]).all() and np.isfinite(row["rot"]).all()
    assert rot_err_deg(row["rot"], rot).max() < POSE_ROT_DEG
    if kw.get("trans_voxel") == "p2p":
        # The plane fits solve A^T A n = -sum(A) in f32, and on these
        # clouds some are so ill-conditioned that both packages' normals
        # stray far from the f64 fit on the same neighbours, so the two
        # refinements part by centimetres (ROADMAP Queue 3); the rotation,
        # shared with B, is held above.
        return
    np.testing.assert_array_less(np.linalg.norm(row["trans"] - trans, axis=1), POSE_TRANS_M)


@functools.lru_cache(maxsize=None)
def _jax_dense_solve():
    """The reference's dense solve, one program for both diagnostics'
    graphs (both hold 64 loop and 32 prior slots)."""
    from rolo_tpu.graph import solve_pose_graph

    return jax.jit(lambda g, r, t, c: solve_pose_graph(g, r, t, c, method="dense"))


def _jax_graph(graph):
    """The port's PoseGraph as the reference's, factor by factor."""
    from rolo_tpu.graph import add_between, empty_graph

    def j(t):
        return jnp.asarray(t.numpy())

    out = empty_graph(graph.odom_rel_rot.shape[0], graph.loops.capacity, graph.priors.capacity)
    out = out._replace(odom_rel_rot=j(graph.odom_rel_rot), odom_rel_trans=j(graph.odom_rel_trans),
                       first_rot=j(graph.first_rot), first_trans=j(graph.first_trans))
    stores = []
    for f, jf in ((graph.loops, out.loops), (graph.priors, out.priors)):
        for n in range(int(f.count)):
            jf = add_between(jf, int(f.i[n]), int(f.j[n]), j(f.rel_rot[n]), j(f.rel_trans[n]),
                             j(f.noise_var[n]), robust_c=j(f.robust_c[n]))
        stores.append(jf)
    return out._replace(loops=stores[0], priors=stores[1])


def _hold_to_reference(graph, rot, trans, count, sols):
    """Each of the port's solutions within POSE_TOL of the reference's dense
    solve of the same graph from the same start."""
    want = np.asarray(_jax_dense_solve()(_jax_graph(graph), jnp.asarray(rot.numpy()),
                                         jnp.asarray(trans.numpy()), jnp.asarray(count)).trans)
    for method, sol in sols.items():
        np.testing.assert_allclose(sol.trans.numpy(), want, rtol=POSE_TOL, atol=POSE_TOL,
                                   err_msg=method)


K_DIAG = 128  # the graph solve diagnostics' bucket on the CPU


def test_dense_solve_decomposition_matches_reference():
    """torch_diag_dense_solve's chain with 24 loops at K = 128: its "dense"
    and "bcr" solutions against the reference's dense solve."""
    tool = _load("torch_diag_dense_solve")
    row, sol, sol_b = tool.decompose(K_DIAG, "cpu", reps=1)
    graph, rot, trans = tool.synth(K_DIAG, "cpu")
    assert int(graph.loops.count) == 24 and row["dense_iterations"] >= 1
    _hold_to_reference(graph, rot, trans, K_DIAG, {"dense": sol, "bcr": sol_b})
    assert row["max_trans_diff_bcr_vs_dense_m"] < POSE_TOL


def test_graphsolve_comparison_matches_reference():
    """torch_diag_graphsolve at the 128 bucket (20 prior-style factors, no
    loop: those span a lap of 512 poses): its "dense" and "pcg" solutions
    against the reference's dense solve, each nearer the truth than the
    drifted start."""
    tool = _load("torch_diag_graphsolve")
    data = tool.big_graph()
    rows, sols = tool.compare(K_DIAG, data, "cpu", reps=1)
    graph, rot0, trans0, cnt = tool.build(K_DIAG, data, "cpu")
    assert int(graph.loops.count) == 0 and int(graph.priors.count) > 0
    _hold_to_reference(graph, rot0, trans0, int(cnt), sols)
    for row in rows.values():
        assert row["max_t_err_m"] < row["start_max_t_err_m"]


def test_prior_funnel_narrows_and_ends_at_the_factors():
    """torch_diag_prior over 28 fixture-size scans, the un-fused chain held
    to prior_cycle at every tick (`check`). The prediction horizon, the
    rotation tolerance and the mapping cadence are changed so that the
    short run reaches the association gates and accepts priors (the
    16-beam odometry's roll drifts past the 5 deg tolerance)."""
    from rolo_tpu_torch.sim import SimConfig
    from rolo_tpu_torch.sim.dataset import generate_sequence, ground_map_points, make_scene

    tool = _load("torch_diag_prior")
    cfg = small_config(**{"mapping.mapping_process_interval": 0.15,
                          "filter.propagate_horizon_m": 1.0,
                          "prior.rot_diff_tolerance_rad": 0.3})
    sim = SimConfig(**{**small_sim_kwargs(28), "period": 24.0})
    scene = make_scene(sim, "cpu")
    report = tool.run(list(generate_sequence(sim, "cpu", scene)), cfg, "cpu",
                      ground_map_points(sim, "cpu", scene), check=True)
    for funnel in report["funnel"].values():
        counts = list(funnel.values())
        assert counts == sorted(counts, reverse=True), funnel
    record, associate = report["funnel"]["record"], report["funnel"]["associate"]
    assert record["ticks"] == len(report["ticks"]) > 0 and record["recorded"] > 0
    assert associate["assoc_accepted"] == report["n_prior_factors"] > 0
    assert sum(row["pushed"] for row in report["ticks"]) == record["recorded"]
    assert sum(row["matched"] for row in report["ticks"]) == associate["assoc_accepted"]


@pytest.mark.parametrize("name", PROFILERS + DIAGNOSTICS)
def test_tool_refuses_to_run_without_a_card(name, monkeypatch):
    """No CUDA device here: each tool's main exits non-zero before it
    measures anything, and falls back to nothing."""
    tool = _load(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    with pytest.raises(SystemExit) as exc:
        tool.main()
    assert exc.value.code not in (0, None) and "CUDA" in str(exc.value.code)
