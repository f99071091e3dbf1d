"""A cell, a traffic mix, a configuration and a per-layer metric are added
by new files and new BENCHMARK.json entries alone (CPU)."""

import hashlib
import json

from . import pbcopy

METRIC = '''"""Calls completed in the measured window."""


def read(ctx):
    return float(ctx.calls)
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts
            and ".build" not in p.parts}


def test_new_cell_from_files_alone(tmp_path):
    root = pbcopy.make_copy(tmp_path / "copy")
    before = _digests(root)
    (root / "portbench" / "limits" / "smm8_b256.f32_tiny.json").write_text(
        json.dumps({"numbers": {"rel_err_max": {"limit": 2e-5}}}))
    (root / "portbench" / "layer_metrics" / "calls_in_window.py").write_text(
        METRIC)
    pbcopy.add_cell(
        root, "smm8_b256.f32_tiny", "smm8_b256", "f32_tiny",
        config_data={"name": "smm8_b256", "kind": "batched_smm", "m": 8,
                     "n": 8, "k": 8, "batch": 256, "beta": 0.0,
                     "settings": {"XSMM_SMM_BACKEND": "pallas"}},
        traffic_data={"driver": "smm_call", "calls_per_step": 2,
                      "trace_steps": 2})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "work_gflops",
        "workloads": ["smm8_b256.f32_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    rows = pbcopy.run_script(root, """
for trace in (False, True):
    res, info = run.run_cell("smm8_b256.f32_tiny", 12345, 0.2, trace, "cpu")
    print(json.dumps(res))
""")
    timed, traced = rows
    assert timed["correct"] is True and traced["correct"] is True
    assert set(timed["metrics"]) == {"work_gflops", "step_ms_p95",
                                     "setup_s"}  # no card: no memory peak
    assert traced["metrics"]["calls_in_window"]["value"] > 0
    assert list(timed)[-1] == "checks"
