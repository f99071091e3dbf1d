"""The packed LU cell on the CPU at a small size (batch 256, 2 applies a
call) in a copy of the benchmark (``pbcopy``): the sound program passes;
the control (factors rounded to bf16), half of the batch left out, one
answer altered and a stale answer, each planted in the kernel wrapper that
runs both triangular solves (``packed_kernels.trsm_loop``), come out not
correct.  A traced run reads the listed metrics that need no card.  And
``roofline_lu.py``'s counts against hand counts."""

import json

import pytest

from portbench import roofline, roofline_lu

from . import pbcopy

REAL, SMALL = "packed_lu_125.bjac_newton16", "t.lu"

SCRIPT = """
from xsmm_tpu_torch.ops import packed_kernels as pk
orig = pk.trsm_loop

def half(*a, **k):          # half of the batch (last axis) left out
    out = orig(*a, **k)
    out[..., out.shape[-1] // 2:] = 0
    return out

def alter(*a, **k):         # one problem's answer altered
    out = orig(*a, **k)
    out[..., 0] += 1.0
    return out

first = []

def stale(*a, **k):         # the first call's answer, for every call
    if not first:
        first.append(orig(*a, **k))
    return first[0].clone()

for case, fn, control in (("program", orig, False), ("control", orig, True),
                          ("half", half, False), ("alter", alter, False),
                          ("stale", stale, False)):
    pk.trsm_loop = fn
    res, info = run.run_cell("t.lu", 2**31 + 11, 0, False, "cpu", steps=3,
                             control=control)
    print(json.dumps({"case": case, "correct": res["correct"],
                      "checks": res["checks"], "keys": list(res),
                      "forbidden": guard.forbidden_loaded()}))
"""


def test_sound_run_passes_and_control_and_faults_fail(tmp_path):
    root = pbcopy.make_copy(tmp_path / "pb")
    pbcopy.small(root, REAL, SMALL, batch=256, applies_per_call=2)
    rows = {r["case"]: r for r in pbcopy.run_script(root, SCRIPT)}
    assert rows["program"]["correct"] is True, rows["program"]
    for case in ("control", "half", "alter", "stale"):
        assert rows[case]["correct"] is False, rows[case]
    assert rows["program"]["keys"] == ["correct", "attempted", "failed",
                                       "metrics", "device", "checks"]
    assert rows["program"]["forbidden"] == []


def test_traced_run_reads_the_host_metrics_listed_for_the_cell(tmp_path):
    """A traced run of the small cell, listed wherever the real cell is,
    reads on the CPU the listed metrics that need no card: the measured
    window's issue and lookup and the passes' build counters.  The card's
    metrics (device and idle shares, rooflines) read nothing here."""
    root = pbcopy.make_copy(tmp_path / "pb")
    pbcopy.small(root, REAL, SMALL, batch=256, applies_per_call=2)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]
              if REAL in m.get("workloads", [])}
    for m in bench["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append(SMALL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    row, = pbcopy.run_script(root, """
res, info = run.run_cell("t.lu", 2**31 + 13, 0, True, "cpu", steps=3)
print(json.dumps({"correct": res["correct"], "metrics": res["metrics"]}))
""")
    assert row["correct"] is True
    assert set(row["metrics"]) == {"host_issue_us", "dispatch_hit_us",
                                   "window_rebuilds"}
    assert set(row["metrics"]) <= listed
    assert row["metrics"]["window_rebuilds"]["value"] == 0


def test_roofline_counts_match_hand_counts():
    config = {"m": 125, "rhs": 1, "batch": 131072}
    traffic = {"applies_per_call": 16}
    b = 131072
    # getrf: n(n-1)/2 divisions + 2 sum_{j<n} j^2; reads A, writes LU
    assert roofline_lu.getrf_call(125, 1) == (1294250, 2 * 125 * 125 * 4)
    # lower (unit): a multiply and an add a term of the strict triangle;
    # upper: the same and a division a row
    assert roofline_lu.trsm_call(125, 1, 1, True) == (15500, 4 * 8000)
    assert roofline_lu.trsm_call(125, 1, 1, False) == (15625, 4 * 8125)
    parts = roofline_lu.parts(config, traffic)
    assert parts["getrf"] == (1294250 * b, 125000 * b)
    assert parts["trsm_lower"] == (16 * 15500 * b, 16 * 32000 * b)
    assert parts["trsm_upper"] == (16 * 15625 * b, 16 * 32500 * b)
    ops, nbytes = roofline_lu.call(config, traffic)
    assert ops == (1294250 + 16 * 31125) * b
    assert round(ops / 1e9, 1) == 234.9
    assert round(parts["getrf"][1] / 1e9, 2) == 16.38
    assert round(parts["trsm_lower"][1] / 16e9, 2) == 4.19
    assert round(parts["trsm_upper"][1] / 16e9, 2) == 4.26
    assert round(nbytes / 1e9, 1) == 151.7
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    t, which = roofline.bound_s(ops, nbytes, peak)
    assert which == "bytes" and abs(t - 45.27e-3) < 1e-5
    assert roofline.bound_s(*parts["getrf"], peak)[1] == "bytes"


@pytest.mark.parametrize("name,part", [("getrf_tile", "getrf"),
                                       ("trsm_shared", "trsm_lower"),
                                       ("trsm_shared_upper", "trsm_upper")])
def test_kernels_are_told_apart_by_name(name, part):
    from types import SimpleNamespace

    summary = SimpleNamespace(device_ns={
        "void getrf_tile": 5, "void trsm_shared<false, 8>": 7,
        "void trsm_shared_upper<false, 8>": 11, "Memcpy DtoD": 13})
    want = {"getrf": 5, "trsm_lower": 7, "trsm_upper": 11}[part]
    assert roofline_lu.kernel_ns(summary, part) == want
    assert name in roofline_lu.KERNELS[part]


def test_config_states_the_cells_sizes():
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    config = json.loads((root / "portbench" / "configs"
                         / "packed_lu_125.json").read_text())
    assert (config["m"], config["batch"], config["dtype"], config["rhs"],
            config["settings"]) == (125, 131072, "float32", 1, {})
    assert config["reduced"] == []
