"""The benchmark on the card (marked ``gpu``; skips without one): every
cell runs to a correct result line, and its control, at the cell's own
sizes, reads above the cell's limit."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import check, run

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in run.load_bench()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _lines(args):
    proc = subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    res = _lines(["portbench/run.py", "--workload", workload, "--seed",
                  "2147483659", "--seconds", "2", "--trace", "0"])[-1]
    assert res["correct"] is True and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    rows = _lines(["portbench/readings.py", "--workload", workload,
                   "--seeds", "", "--control-seeds", "2147483661",
                   "--steps", "2"])
    limits = check.load_limits(REPO / "portbench" / "limits"
                               / f"{workload}.json")
    got = rows[0]["numbers"]
    assert any(got[k] > limits[k] for k in limits), got
