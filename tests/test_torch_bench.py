"""The port bench (``python -m xsmm_tpu_torch.bench``) on the CPU target:
one JSON line with the root bench.py's keys and metric name, and no JAX in
the process."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# the keys of the root bench.py's line (bench.py:132-155)
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"batch", "seconds_per_call", "spread", "achieved_gbps",
               "roofline_gflops", "roofline_frac", "device", "f64_strategy"}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XSMM_F64", "XSMM_SMM_BACKEND")}
    env.update(PYTHONPATH=str(REPO), XSMM_TARGET="cpu", **extra)
    return env


def test_port_bench_prints_one_line_with_the_root_bench_keys(tmp_path):
    res = subprocess.run([sys.executable, "-m", "xsmm_tpu_torch.bench"],
                         cwd=tmp_path, env=_env(XSMM_BENCH_B="256"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert set(out) == TOP_KEYS
    assert out["metric"] == "batched_f64_smm_23x23x23_gflops_per_chip"
    # the value is rounded to 0.1 GFLOP/s as in the root bench: a busy CPU
    # at B 256 may round to 0.0
    assert out["unit"] == "GFLOP/s" and out["value"] >= 0
    d = out["detail"]
    assert DETAIL_KEYS <= set(d)
    assert d["batch"] == 256 and d["device"] == "cpu"
    assert d["f64_strategy"] == "split2_fast" and d["spread"] is None
    assert d["seconds_per_call"] > 0 and d["fast_float32_gflops"] >= 0
    assert d["dispatch_hit_us"] > 0 and d["whole_call_ms"] > 0
    # the two yardsticks: f64-equivalent I/O (24 B a problem element) and
    # the split2_fast planes' real bytes (16 B)
    assert d["plane_bytes"] == (23 * 23 * 4) * 4 * 256
    assert d["plane_bound_frac"] <= d["roofline_frac"]
    gflops = 2 * 23 ** 3 * 256 / d["seconds_per_call"] / 1e9
    assert abs(out["value"] - gflops) <= 0.05 + 1e-9
    assert abs(out["vs_baseline"]
               - gflops / (0.8 * d["roofline_gflops"])) <= 2e-3


def test_port_bench_imports_no_jax(tmp_path):
    code = ("import json, sys\n"
            "from xsmm_tpu_torch import bench\n"
            "out = bench.run()\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'xsmm_tpu.')) or m == 'xsmm_tpu']\n"
            "assert not bad, bad\n"
            "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_env(XSMM_BENCH_B="64"), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["detail"][
        "batch"] == 64
