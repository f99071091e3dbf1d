"""The comparison that decides ``correct``, on the CPU at small sizes:
sound runs pass; the control, half of the batch left out, an answer
altered where it is produced, and a stale answer (the first call's,
returned for every later call) each come out not correct.

Each cell runs in a copy of the benchmark (``pbcopy``) at a smaller size
under the real cell's limits, through ``run.run_cell`` with the look for a
card skipped; the faults are planted in the program's kernel wrappers."""

import pytest

from . import pbcopy

# real cell -> (small cell, its sizes, the kernel wrapper its timed path
# calls: module and function)
CELLS = {
    "smm23_b131072.f64_planes": ("t.f64_planes", {"batch": 2048},
                                 ("smm_packed", "packed_split2_fast")),
    "smm23_b131072.f32_natural": ("t.f32_natural", {"batch": 2048},
                                  ("smm_packed", "packed_f32")),
    "pyfr_hex_p4_m0.acc_n64k": ("t.acc", {"n": 4096},
                            ("spgemm_kernels", "acc_f64")),
}

SCRIPT = """
import importlib
mod = importlib.import_module("xsmm_tpu_torch.ops.{module}")
orig = getattr(mod, "{fn}")

def half(*a, **k):          # half of the batch (last axis) left out
    out = orig(*a, **k)
    for t in (out if isinstance(out, tuple) else (out,)):
        t[..., t.shape[-1] // 2:] = 0
    return out

def alter(*a, **k):         # one problem's answer altered
    out = orig(*a, **k)
    (out[0] if isinstance(out, tuple) else out)[..., 0] += 1.0
    return out

first = []

def stale(*a, **k):         # the first call's answer, for every call
    if not first:
        first.append(orig(*a, **k))
    out = first[0]
    return (tuple(t.clone() for t in out) if isinstance(out, tuple)
            else out.clone())

for case, fn, control in (("program", orig, False), ("control", orig, True),
                          ("half", half, False), ("alter", alter, False),
                          ("stale", stale, False)):
    setattr(mod, "{fn}", fn)
    res, info = run.run_cell("{cell}", 2**31 + 11, 0, False, "cpu",
                             steps=3, control=control)
    print(json.dumps({{"case": case, "correct": res["correct"],
                      "checks": res["checks"], "keys": list(res),
                      "forbidden": guard.forbidden_loaded()}}))
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = pbcopy.make_copy(tmp_path_factory.mktemp("pb"))
    for real, (name, sizes, _) in CELLS.items():
        pbcopy.small(root, real, name, **sizes)
    return root


@pytest.mark.parametrize("real", sorted(CELLS))
def test_sound_run_passes_and_control_and_faults_fail(copy, real):
    name, _, (module, fn) = CELLS[real]
    rows = {r["case"]: r for r in pbcopy.run_script(
        copy, SCRIPT.format(module=module, fn=fn, cell=name))}
    assert rows["program"]["correct"] is True, rows["program"]
    for case in ("control", "half", "alter", "stale"):
        assert rows[case]["correct"] is False, rows[case]
    assert rows["program"]["keys"] == ["correct", "attempted", "failed",
                                       "metrics", "device", "checks"]
    assert rows["program"]["forbidden"] == []
