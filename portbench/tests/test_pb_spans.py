"""The program's spans and build counters in the benchmark, on the CPU: a
traced run reads the host metrics from the span passes; recording is never
on in a ``--trace 0`` run, nor during the measured window or the two
captures that the existing metrics and the breakdown read; a program that
records no spans leaves the new metrics out."""

import json

import pytest

from . import pbcopy

# real cell -> its small copy and sizes
CELLS = {"smm23_b131072.f64_planes": ("t.f64_planes", {"batch": 1024}),
         "smm23_b131072.f32_natural": ("t.f32_natural", {"batch": 1024}),
         "pyfr_hex_p4_m0.acc_n64k": ("t.acc", {"n": 2048})}

SCRIPT = """
from xsmm_tpu_torch.utils import trace

phase = ["window"]
seen = []                       # (phase, recording on) of every step
step = run.Loop.step

def spy_step(self, *a, **k):
    seen.append((phase[0], trace.recording_on()))
    return step(self, *a, **k)

traced = run.traced

def spy_traced(*a, **k):
    phase[0] = "captures"
    try:
        return traced(*a, **k)
    finally:
        phase[0] = "passes"

run.Loop.step = spy_step
run.traced = spy_traced
for trace_on in (False, True):
    phase[0] = "window"
    del seen[:]
    res, info = run.run_cell("{cell}", 2**31 + 29, 0, trace_on, "cpu",
                             steps=3)
    print(json.dumps({{"trace": trace_on, "correct": res["correct"],
                      "attempted": res["attempted"],
                      "metrics": res["metrics"], "seen": seen,
                      "on_after": trace.recording_on()}}))
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A copy of the benchmark with the small cells, each named in the
    ``workloads`` of every per-layer metric its real cell is named in."""
    root = pbcopy.make_copy(tmp_path_factory.mktemp("pbspans"))
    for real, (name, sizes) in CELLS.items():
        pbcopy.small(root, real, name, **sizes)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        m["workloads"] += [CELLS[w][0] for w in list(m["workloads"])
                           if w in CELLS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("real", sorted(CELLS))
def test_traced_run_reads_the_program_spans(copy, real):
    name = CELLS[real][0]
    untraced, traced = pbcopy.run_script(copy, SCRIPT.format(cell=name))
    # --trace 0: recording never on, and no per-layer metric read
    assert untraced["correct"] is True
    assert untraced["seen"] and not any(on for _, on in untraced["seen"])
    # --trace 1: off in the window and both captures; in the passes, off
    # for the second loop's first step, then on for 2 steps of each pass
    assert traced["correct"] is True and not traced["on_after"]
    phases = {}
    for ph, on in traced["seen"]:
        phases.setdefault(ph, []).append(on)
    assert set(phases["window"]) == {False} == set(phases["captures"])
    assert phases["passes"] == [False] + [True] * 4
    # 3 calls a step: 3 window steps and 2 steps of each capture; the
    # passes' calls are not the run's
    assert traced["attempted"] == 3 * 3 + 2 * 2 * 3
    m = traced["metrics"]
    for key in ("frontend_host_us", "wrapper_host_us"):
        assert m[key]["value"] > 0, key
    assert m["frontend_host_us"]["issue_us"] >= (
        m["frontend_host_us"]["value"] + m["wrapper_host_us"]["value"])
    assert m["window_rebuilds"]["value"] == 0
    assert set(m["window_rebuilds"]["by_counter"]) == {
        "compiled", "loaded", "routes", "jit", "captures"}
    # the CPU launches nothing and has no card's timeline
    assert "launch_host_us" not in m and "idle_in_program_share" not in m
    if name == "t.acc":
        assert "dispatch_span_us" not in m
        d = m["create_digest_us"]
        assert 0 < d["value"] < d["create_us"]
    else:
        assert m["dispatch_span_us"]["value"] > 0
        assert "create_digest_us" not in m


NO_SPANS = """
from xsmm_tpu_torch.utils import trace

del trace.recording
res, info = run.run_cell("{cell}", 2**31 + 31, 0, True, "cpu", steps=2)
print(json.dumps({{"correct": res["correct"], "metrics": res["metrics"]}}))
"""

NEW = ("dispatch_span_us", "create_digest_us", "frontend_host_us",
       "wrapper_host_us", "launch_host_us", "idle_in_program_share",
       "window_rebuilds")


@pytest.mark.parametrize("real", sorted(CELLS))
def test_program_without_spans_leaves_the_new_metrics_out(copy, real):
    (res,) = pbcopy.run_script(copy, NO_SPANS.format(cell=CELLS[real][0]))
    assert res["correct"] is True
    assert res["metrics"] and not set(NEW) & set(res["metrics"])
