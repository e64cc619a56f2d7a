"""`python -m rolo_tpu_torch run` / `sim` on the CPU (`--device cpu`), held to
the JAX package's CLI bounds: the bag fixture through the native reader,
SlamSystem and the exports (tests/test_cpp_host.py:200-221), and a simulated
sequence written to disk and run back (tests/test_cli.py:86-114). Without
`--device` the CLI takes the card."""

import json
import os

import pytest
import torch

from torch_parity import REPO

from rolo_tpu_torch.__main__ import main as cli_main

FIXTURE = os.path.join(REPO, "tests", "fixtures", "sim_bag")


def _result(capsys) -> dict:
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


def test_run_on_bag(tmp_path, capsys):
    from rolo_tpu_torch.cpp import host

    if not host.is_available():
        pytest.skip("librolo_host cannot be built here")
    out_dir = str(tmp_path / "out")
    rc = cli_main(["run", "--input", os.path.join(FIXTURE, "seq.bag"),
                   "--config", os.path.join(FIXTURE, "config.yaml"),
                   "--gt", os.path.join(FIXTURE, "gt_tum.txt"),
                   "--output", out_dir, "--progress", "0", "--device", "cpu"])
    assert rc == 0
    res = _result(capsys)
    assert res["n_scans"] == 12
    assert res["ate_frontend_rmse_m"] < 0.5
    for name in ("front_end_tum.txt", "optimized_tum.txt", "pose_graph.g2o", "global_map.pcd",
                 "result.json"):
        assert os.path.exists(os.path.join(out_dir, name)), name


def test_sim_then_run_dir(tmp_path, capsys):
    seq_dir = str(tmp_path / "seq")
    rc = cli_main(["sim", "--output", seq_dir, "--scans", "6", "--cols", "512", "--period", "60",
                   "--seed", "0", "--sensor", "velodyne16", "--device", "cpu"])
    assert rc == 0
    assert len([f for f in os.listdir(seq_dir) if f.endswith(".pcd")]) == 6
    capsys.readouterr()
    out_dir = str(tmp_path / "out")
    rc = cli_main(["run", "--input", seq_dir, "--config", os.path.join(FIXTURE, "config.yaml"),
                   "--gt", os.path.join(seq_dir, "gt_tum.txt"), "--output", out_dir,
                   "--progress", "0", "--device", "cpu"])
    assert rc == 0
    res = _result(capsys)
    assert res["n_scans"] == 6 and res["ate_frontend_rmse_m"] < 0.5
    assert os.path.exists(os.path.join(out_dir, "result.json"))


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        cli_main(["sim", "--output", str(tmp_path / "seq"), "--scans", "1", "--cols", "64"])
