"""The runtime's host side against the JAX package's: the exporters write the
same bytes from the same seeded inputs, the readers and the trajectory
metrics give equal arrays, the native reader (built by each package from
cpp/rolo_host.cpp) decodes the bag fixture alike, the port's own YAML reader
reads every parameter file as yaml.safe_load does, and its StageTimers
summarize alike."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
import yaml

import torch_parity
from torch_parity import REPO

from rolo_tpu import config as jconfig
from rolo_tpu.runtime import bagwriter as jbagwriter
from rolo_tpu.runtime import io as jio
from rolo_tpu.runtime import metrics as jmetrics
from rolo_tpu.runtime import profiling as jprofiling
from rolo_tpu.runtime import viz as jviz

from rolo_tpu_torch import config as pconfig
from rolo_tpu_torch.runtime import bagwriter, io, metrics, profiling, viz

FIXTURE_BAG = os.path.join(REPO, "tests", "fixtures", "sim_bag", "seq.bag")
YAML_FILES = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True)
                    + glob.glob(os.path.join(REPO, "tests", "fixtures", "**", "*.yaml"),
                                recursive=True))


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _write_cases():
    """name -> (writer(module, path, rng)): each writes with the module's
    functions from draws of `rng`."""
    def tum(m, path, rng):
        m.write_tum(path, np.cumsum(rng.uniform(0.05, 0.15, 20)), rng.normal(size=(20, 3)) * 30,
                    _quats(rng, 20))

    def g2o(m, path, rng):
        edges = [(i, i + 1, rng.normal(size=3), _quats(rng, 1)[0]) for i in range(6)]
        m.write_g2o(path, rng.normal(size=(7, 3)), _quats(rng, 7), edges, edges[:2], edges[3:])

    def pcd(binary, intensity):
        def write(m, path, rng):
            pts = rng.normal(size=(300, 3)).astype(np.float32) * 20
            m.write_pcd(path, pts, rng.uniform(0, 255, 300) if intensity else None, binary=binary)
        return write

    def ply(color):
        def write(m, path, rng):
            pts = rng.normal(size=(50, 3)) * 5
            m.write_ply(path, pts, rng.integers(0, 256, (50, 3)) if color else None)
        return write

    def ply_graph(m, path, rng):
        m.write_ply_graph(path, rng.normal(size=(8, 3)), [(i, i + 1) for i in range(7)] + [(7, 0)],
                          [(150, 150, 150)] * 7 + [(220, 40, 40)])

    def bag(m, path, rng):
        scans = [(100.0 + 0.1 * i, rng.normal(size=(200 + 30 * i, 3)).astype(np.float32) * 10,
                  rng.uniform(0, 100, 200 + 30 * i), rng.integers(0, 16, 200 + 30 * i),
                  rng.uniform(0, 0.1, 200 + 30 * i)) for i in range(3)]
        m.write_bag(path, scans)

    return {"tum": (tum, "io"), "g2o": (g2o, "io"), "pcd_binary": (pcd(True, False), "io"),
            "pcd_binary_intensity": (pcd(True, True), "io"), "pcd_ascii": (pcd(False, True), "io"),
            "ply": (ply(False), "viz"), "ply_color": (ply(True), "viz"),
            "ply_graph": (ply_graph, "viz"), "bag": (bag, "bagwriter")}


MODULES = {"io": (io, jio), "viz": (viz, jviz), "bagwriter": (bagwriter, jbagwriter)}


@pytest.mark.parametrize("case", sorted(_write_cases()))
def test_exports_are_byte_identical(case, tmp_path):
    write, module = _write_cases()[case]
    port, ref = MODULES[module]
    write(port, str(tmp_path / "port"), np.random.default_rng(7))
    write(ref, str(tmp_path / "ref"), np.random.default_rng(7))
    got, want = (tmp_path / "port").read_bytes(), (tmp_path / "ref").read_bytes()
    assert len(want) > 100 and got == want


@pytest.mark.parametrize("case", ["pcd_binary_intensity", "pcd_ascii", "tum", "kitti"])
def test_readers_match_reference(case, tmp_path):
    path = str(tmp_path / "f")
    rng = np.random.default_rng(3)
    if case == "kitti":
        rng.normal(size=(40, 4)).astype(np.float32).tofile(path)
        np.testing.assert_array_equal(io.read_kitti_bin(path), jio.read_kitti_bin(path))
        return
    _write_cases()[case][0](jio, path, rng)
    if case == "tum":
        for got, want in zip(io.read_tum(path), jio.read_tum(path)):
            np.testing.assert_array_equal(got, want)
        return
    got, want = io.read_pcd(path), jio.read_pcd(path)
    assert set(got) == set(want) == {"x", "y", "z", "intensity"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_metrics_match_reference():
    rng = np.random.default_rng(5)
    gt = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    c, s = np.cos(0.4), np.sin(0.4)
    est = gt @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T + [3.0, -1.0, 0.5]
    est += rng.normal(0, 0.05, est.shape)
    for got, want in zip(metrics.umeyama_alignment(est, gt, with_scale=True),
                         jmetrics.umeyama_alignment(est, gt, with_scale=True)):
        np.testing.assert_array_equal(got, want)
    for align in (True, False):
        got, want = metrics.ate(est, gt, align), jmetrics.ate(est, gt, align)
        assert got[:4] == want[:4]
        np.testing.assert_array_equal(got.errors, want.errors)
    assert metrics.rpe(est, gt, 3) == jmetrics.rpe(est, gt, 3)
    ta, tb = np.sort(rng.uniform(0, 10, 50)), np.sort(rng.uniform(0, 10, 70))
    for got, want in zip(metrics.associate_by_time(ta, tb, 0.05),
                         jmetrics.associate_by_time(ta, tb, 0.05)):
        np.testing.assert_array_equal(got, want)


def test_vehicle_outline_matches_reference():
    from rolo_tpu.prior import vehicle as jvehicle

    from rolo_tpu_torch.prior import vehicle

    cfg = jconfig.load_config([os.path.join(REPO, "configs", "params.yaml")])
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    got = viz.vehicle_outline(vehicle.from_config(torch_parity.port_config(cfg).prior, "cpu"), rot,
                              np.array([1.0, 2.0, 0.5]))
    want = jviz.vehicle_outline(jvehicle.from_config(cfg.prior), rot, np.array([1.0, 2.0, 0.5]))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_stage_timers_match_reference():
    got, want = profiling.StageTimers(), jprofiling.StageTimers()
    for t in (got, want):
        with t.stage("a", sync=torch.zeros(1)):
            pass
        for x in (0.5, 1.5, 0.25):
            t.record("b", x)
    assert got.summary()["b"] == want.summary()["b"]
    assert got.summary()["a"]["count"] == 1
    assert got.report().splitlines()[0] == want.report().splitlines()[0]


@pytest.mark.parametrize("path", YAML_FILES, ids=[os.path.relpath(p, REPO) for p in YAML_FILES])
def test_yaml_reader_matches_safe_load(path):
    """The port's reader against PyYAML, and load_config against the JAX
    package's, field for field."""
    with open(path) as f:
        text = f.read()
    assert pconfig.parse_yaml(text) == yaml.safe_load(text)
    got, want = pconfig.load_config(path), jconfig.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2\n",            # block sequence
    "a: {b: 1}\n",                   # flow mapping
    "a: &x 1\nb: *x\n",              # anchor and alias
    "a: !!str 1\n",                  # tag
    "a: |\n  text\n",                # block scalar
    "a: 0x1f\n", "a: 017\n",         # hex, octal
    "a: 1e-8\n",                     # a string to YAML 1.1, a number to a reader
    "a: \"x\\ny\"\n",                # escape
    "a: 1\na: 2\n",                  # duplicate key
    "a: [1, 2\n",                    # unterminated flow list
    "a: 1\n  b: 2\n",                # stray indentation
    "---\na: 1\n",                   # document marker
    "a: [1, [2]]\n",                 # nested flow list
])
def test_yaml_reader_refuses_outside_the_subset(text):
    with pytest.raises(ValueError):
        pconfig.parse_yaml(text)


def test_yaml_reader_scalars_and_flow_lists():
    text = ("rolo:  # comment\n  n: 16\n  f: -3.0046\n  e: 1.0e-8\n  b: true\n  s: velodyne\n"
            "  q: \"/results/\"\n  z: ~\n  l: [-3.0046, 0.7836,\n        0.8942, 1]\n  m:\n")
    assert pconfig.parse_yaml(text) == yaml.safe_load(text)
    assert pconfig.parse_yaml("# only a comment\n") is None


def _native_pair():
    from rolo_tpu.cpp import host as jhost

    from rolo_tpu_torch.cpp import host

    if not (host.is_available() and jhost.is_available()):
        pytest.skip("librolo_host cannot be built here")
    return host, jhost


def test_native_bag_reader_matches_reference():
    host, jhost = _native_pair()
    bag, jbag = host.BagReader(FIXTURE_BAG), jhost.BagReader(FIXTURE_BAG)
    assert bag.connections == jbag.connections
    assert len(bag) == len(jbag) == 12
    for i in range(len(bag)):
        assert bag.message_info(i) == jbag.message_info(i)
        got, want = bag.read_pointcloud2(i), jbag.read_pointcloud2(i)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert str(host.library_path()).startswith(os.path.join(REPO, "build", "rolo_tpu_torch"))


def test_native_pcd_and_queue_match_reference(tmp_path):
    host, jhost = _native_pair()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"{i}.pcd")
        io.write_pcd(p, rng.normal(size=(100 + i, 3)), intensity=rng.uniform(0, 9, 100 + i))
        paths.append(p)
    for p in paths:
        got, want = host.read_pcd_native(p), jhost.read_pcd_native(p)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    q = host.ScanPrefetchQueue(paths, capacity=256, depth=2)
    seen = []
    while (scan := q.pop()) is not None:
        np.testing.assert_array_equal(scan["xyz"], jhost.read_pcd_native(paths[scan["index"]])["xyz"])
        seen.append(scan["index"])
    q.close()
    assert seen == [0, 1, 2]
