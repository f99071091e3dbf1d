"""The ResNet-50 training cell on the CPU at a small size (width 8, 64 x 64
images, batch 8, 10 classes) in a copy of the benchmark (``pbcopy``),
under the real cell's limits: the sound program passes and
``readings.py`` reads it; faults planted in the training engine (half of
the batch's labels left out of the loss, a stale step that applies the
previous call's update again, one leaf's update altered, the loss altered)
come out not correct.  The small cell runs in f32: at this size a bf16
step's update is dominated by the finite-precision effect the cell's
numbers are chosen around (PERF.md), which the card's size shows in
proportion; the limits are the card's.  A traced run reads the listed
metrics that need no card.  And the driver's state mapping against the
engine's leaves."""

import dataclasses
import json

import torch

from . import pbcopy

REAL, SMALL = "resnet50_train.bf16_b256", "t.rn"
SIZES = dict(width=8, image=64, batch=8, classes=10, dtype="float32",
             pretrain_steps=2)

# each script's process takes a few of the CPU's threads: the tests run
# side by side under xdist
THREADS = "import torch\ntorch.set_num_threads(4)\n"

SCRIPT = THREADS + """
from xsmm_tpu_torch.models import engine as pe

Engine = pe.MLEngine
step, loss_of = Engine.train_step, Engine._weighted_loss

def half(self, logits, y):      # half of the batch's labels left out
    n = y.shape[0] // 2
    return loss_of(self, logits[:n], y[:n])

def _fc_w(self):                # the classifier's weight leaf
    return self.params["layers"][-1]["w"]

def altered(self, x, y):        # the classifier's update doubled
    before = _fc_w(self).detach().clone()
    out = step(self, x, y)
    with torch.no_grad():
        _fc_w(self).add_(_fc_w(self) - before)
    return out

def stale(self, x, y):          # the previous call's update applied again
    leaves = [t for _, t in pe.tree_flatten_with_path(self.params)]
    if not hasattr(self, "_last"):
        before = [t.detach().clone() for t in leaves]
        out = step(self, x, y)
        self._last = (out, [t.detach() - b for t, b in zip(leaves, before)])
        return out
    out, delta = self._last
    with torch.no_grad():
        torch._foreach_add_(leaves, delta)
    self.step += 1
    return out.clone()

def loss_plus(self, x, y):      # the loss altered
    return step(self, x, y) + 1.0

for case, patch in (("program", {}), ("half", {"_weighted_loss": half}),
                    ("stale", {"train_step": stale}),
                    ("altered", {"train_step": altered}),
                    ("loss", {"train_step": loss_plus})):
    Engine.train_step, Engine._weighted_loss = step, loss_of
    for name, fn in patch.items():
        setattr(Engine, name, fn)
    res, info = run.run_cell("t.rn", 2**31 + 11, 0, False, "cpu", steps=3)
    print(json.dumps({"case": case, "correct": res["correct"],
                      "checks": res["checks"], "numbers": info["numbers"],
                      "forbidden": guard.forbidden_loaded()}))
"""


def _small(tmp_path):
    root = pbcopy.make_copy(tmp_path / "pb")
    pbcopy.small(root, REAL, SMALL, **SIZES)
    return root


def test_sound_run_passes_and_faults_fail(tmp_path):
    rows = {r["case"]: r for r in pbcopy.run_script(_small(tmp_path),
                                                    SCRIPT)}
    assert rows["program"]["correct"] is True, rows["program"]
    assert rows["program"]["forbidden"] == []
    for case in ("half", "stale", "altered", "loss"):
        assert rows[case]["correct"] is False, rows[case]
    limits = {k: c["limit"] for k, c in rows["program"]["checks"].items()}
    fc, loss = rows["altered"]["checks"], rows["loss"]["checks"]
    assert fc["fc_update_rel_err"]["value"] > limits["fc_update_rel_err"]
    assert loss["loss_rel_err"]["value"] > limits["loss_rel_err"]
    for case in ("half", "stale"):
        assert rows[case]["checks"]["fc_update_rel_err"]["value"] > \
            limits["fc_update_rel_err"], rows[case]


def test_readings_read_the_program_and_the_control(tmp_path):
    """``readings.py`` on the small cell: a line a seed, the program's
    numbers within the limits; the control (the reference with float8
    conv operands) reads above the program on the classifier's update."""
    root = _small(tmp_path)
    rows = pbcopy.run_script(root, THREADS + """
import sys
from portbench import readings
sys.argv = ["readings.py", "--workload", "t.rn", "--seeds", "11,12",
            "--control-seeds", "21", "--steps", "3", "--device", "cpu"]
readings.main()
""")
    program = [r for r in rows if r.get("side") == "program"]
    control = [r for r in rows if r.get("side") == "control"]
    assert len(program) == 2 and len(control) == 1
    limits = json.loads((root / "portbench" / "limits"
                         / f"{REAL}.json").read_text())["numbers"]
    for r in program:
        for k, v in r["numbers"].items():
            assert v <= limits[k]["limit"], (k, v)
    worst = max(r["numbers"]["fc_update_rel_err"] for r in program)
    assert control[0]["numbers"]["fc_update_rel_err"] > 10 * worst
    assert rows[-1]["lower"] and rows[-1]["upper"]


def test_traced_run_reads_the_host_metrics_listed_for_the_cell(tmp_path):
    """A traced run of the small cell, listed wherever the real cell is,
    reads on the CPU what needs no card: the calls' host issue, and the
    engine's forms (eager on the CPU, so every step is a graph miss).  The
    card's metrics (device shares, the MFU) read nothing here."""
    root = _small(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]
              if REAL in m.get("workloads", [])}
    for m in bench["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append(SMALL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    row, = pbcopy.run_script(root, THREADS + """
res, info = run.run_cell("t.rn", 2**31 + 13, 0, True, "cpu", steps=3)
print(json.dumps({"correct": res["correct"], "metrics": res["metrics"],
                  "steps": info["steps"]}))
""")
    assert row["correct"] is True
    assert set(row["metrics"]) == {"host_issue_us", "graph_misses"}
    assert listed == {"host_issue_us", "device_idle_share", "step_mfu",
                      "conv_gemm_device_share", "graph_misses"}
    forms = row["metrics"]["graph_misses"]["forms"]
    assert forms["captures"] == 0 and forms["eager"] > 0
    assert row["metrics"]["graph_misses"]["value"] == forms["eager"]


def test_driver_state_maps_the_engines_leaves():
    """The driver's flat state in the engine's leaf order, read back as the
    reference's named leaves (and written back from them), is the
    reference's conversion of the engine's tree, value for value."""
    import xsmm_tpu_torch as xp
    from portbench.drivers import resnet_train
    from portbench.reference import resnet as ref
    from xsmm_tpu_torch.models import engine as pe

    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    try:
        drv = resnet_train.Driver(
            {"depth": 50, "batch": 2, "image": 32, "classes": 10,
             "width": 8, "dtype": "float32",
             "solver": {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4}},
            {"calls_per_step": 1, "pretrain_steps": 0},
            torch.device("cpu"), 5)
        with torch.no_grad():
            for i, (_, t) in enumerate(pe.tree_flatten_with_path(
                    drv.engine.momentum)):
                t.fill_(i)
        flat = drv._flat(drv._leaves, drv._moms)
        params, moms = drv._named(flat)
        want = ref.from_engine(drv.engine.params["layers"])
        want_m = ref.from_engine(drv.engine.momentum["layers"])
        assert list(params) == list(want)
        for k in want:
            assert torch.equal(params[k], want[k]), k
            assert torch.equal(moms[k], want_m[k]), k
        assert torch.equal(drv._to_flat(params, moms), flat)
    finally:
        xp.set_config(**saved)
