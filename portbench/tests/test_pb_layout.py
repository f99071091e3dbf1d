"""The benchmark's files, its yardstick and the frozen copies (CPU)."""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, guard, inputs, pyfr_ops, roofline, run

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    spec = run.resolve(BENCH, workload)
    assert spec.config["name"] == spec.cell["config"]
    driver = importlib.import_module(spec.driver)
    assert set(check.load_limits(spec.limits)) == set(driver.Driver.numbers)
    for entries, package in ((BENCH["end_to_end"], "e2e_metrics"),
                             (BENCH["per_layer"], "layer_metrics")):
        for m in entries:
            if run.applies(m, workload):
                mod = importlib.import_module(f"portbench.{package}."
                                              f"{m['name']}")
                assert callable(mod.read)


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


# (ops, bytes) by hand: the planes of each call, 4 bytes an element; the
# sparse call adds its operator (row pointers, columns, two value planes)
HAND = {
    "smm23_b131072.f64_planes": (2 * 23 ** 3 * 131072,
                                 4 * 23 * 23 * 131072 * 4),  # ah bh bl -> c
    "smm23_b131072.f32_natural": (2 * 23 ** 3 * 131072,
                                  3 * 23 * 23 * 131072 * 4),  # a b -> c
    "pyfr_hex_p4_m0.acc_n64k": (2 * 750 * 65536,
                                (2 * 125 + 4 * 150) * 65536 * 4
                                + (151 + 750) * 4 + 2 * 750 * 4),
}


def test_roofline_counts_match_hand_counts():
    assert HAND["smm23_b131072.f64_planes"][1] == 1109393408      # 1.109 GB
    assert round(HAND["smm23_b131072.f64_planes"][0] / 1e9, 2) == 3.19
    assert roofline.smm_call(23, 23, 23, 131072, (1, 2), 1) == \
        HAND["smm23_b131072.f64_planes"]
    assert roofline.smm_call(23, 23, 23, 131072, (1, 1), 1) == \
        HAND["smm23_b131072.f32_natural"]
    assert roofline.sparse_acc_call(150, 125, 65536, 750, 2, 2, 2) == \
        HAND["pyfr_hex_p4_m0.acc_n64k"]
    assert HAND["pyfr_hex_p4_m0.acc_n64k"] == (98304000, 222832004)
    ops, nbytes = roofline.sparse_acc_call(150, 125, 2 ** 20, 750, 2, 2, 2)
    assert (round(nbytes / 1e9, 3), round(ops / 1e9, 3)) == (3.565, 1.573)
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    t, which = roofline.bound_s(*HAND["smm23_b131072.f64_planes"], peak)
    assert which == "bytes" and abs(t - 0.331e-3) < 1e-6


def test_peak_table_refuses_an_unknown_card():
    with pytest.raises(KeyError):
        roofline.peaks("NVIDIA A100-SXM4-80GB")


def _hex_points(order):
    """PyFR's hex solution and flux points at Gauss-Legendre nodes, in the
    order of ``pyfr_ops.hex_m0``'s columns and rows."""
    r = np.polynomial.legendre.leggauss(order + 1)[0]
    p1 = len(r)
    upts = [(r[i], r[j], r[k]) for k in range(p1) for j in range(p1)
            for i in range(p1)]
    fpts = []
    for axis in range(3):
        tang = [ax for ax in range(3) if ax != axis]
        for end in (-1.0, 1.0):
            for t1 in range(p1):
                for t0 in range(p1):
                    q = [0.0] * 3
                    q[axis], q[tang[0]], q[tang[1]] = end, r[t0], r[t1]
                    fpts.append(tuple(q))
    return np.array(upts), np.array(fpts)


def test_pyfr_hex_m0_interpolates_to_the_flux_points():
    config = json.loads((REPO / "portbench" / "configs"
                         / "pyfr_hex_p4_m0.json").read_text())
    op = pyfr_ops.operator(config["operator"])
    assert op.shape == (150, 125)
    assert int((op != 0).sum()) == 750 == config["operator"]["nnz"]
    assert set((op != 0).sum(axis=1)) == {5}
    upts, fpts = _hex_points(4)
    for f in (lambda x, y, z: x ** 4 * y ** 3 - 2 * z ** 4 * x + y * z + 0.3,
              lambda x, y, z: np.ones_like(x)):
        got = op @ f(*upts.T)
        assert np.abs(got - f(*fpts.T)).max() < 1e-13


def test_true_split_carries_the_residual():
    x = inputs.normal((4096,), torch.float64, torch.device("cpu"), 5, 0)
    hi, lo = inputs.split_hi_lo(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert (lo != 0).float().mean() > 0.99
    assert torch.equal(lo, (x - hi.double()).float())
    resid = (x - (hi.double() + lo.double())).abs()
    assert bool((resid <= 2.0 ** -47 * x.abs()).all())


def test_seeds_give_other_data_and_the_same_data_again():
    dev = torch.device("cpu")
    a = inputs.normal((64,), torch.float32, dev, 7, 0)
    assert torch.equal(a, inputs.normal((64,), torch.float32, dev, 7, 0))
    assert not torch.equal(a, inputs.normal((64,), torch.float32, dev,
                                            7 + 2 ** 32, 0))
    assert not torch.equal(a, inputs.normal((64,), torch.float32, dev, 7, 1))


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["jax.numpy", "xsmm_tpu.ops", "numpy",
                                   "xsmm_tpu_torch.ops", "flax"]) == \
        ["flax", "jax", "xsmm_tpu"]
    assert guard.forbidden_loaded(["xsmm_tpu_torch", "torch"]) == []


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert proc.returncode == 2 and proc.stdout == ""


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    (tmp_path / "portbench").mkdir()
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""
