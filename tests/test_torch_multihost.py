"""xsmm_tpu_torch's multi-process run (parallel/multihost.py) on the CPU.

Two processes of two ranks each join over gloo (a ``tcp://`` address on a
free port) at the JAX dryrun's sizes (``xsmm_tpu/parallel/multihost.py``
64-106: ResNet-18 width 8, 32 classes, batch 2 x dp; the ring over an
48 x 8d operator at density 0.2, N 128): the dp x mp train step and the
ring CSR SpMM, both across the process boundary.  The run carries its own
timeout (120 s) and kills every worker when it passes; a worker takes a
few seconds.  Unlike ``tests/test_multihost.py`` (the JAX package's, which
takes minutes) this runs in the hermetic suite.
"""

import dataclasses

import pytest

import xsmm_tpu_torch as xp
from xsmm_tpu_torch.parallel import multihost


@pytest.fixture(autouse=True)
def cpu_target():
    saved = dataclasses.asdict(xp.get_config())
    xp.set_config(target="cpu")
    yield
    xp.set_config(**saved)


def test_launch_dryrun_two_processes_of_two():
    lines = multihost.launch_dryrun(2, 2, timeout_s=120)
    assert len(lines) == 2
    for pid, ln in enumerate(lines):
        assert ln.startswith(f"[proc {pid}] multihost dryrun OK: 2 processes"
                             f" x 2 ranks on cpu, backend gloo")
    # both processes report the same global loss
    losses = {ln.split("loss=")[1].split(",")[0] for ln in lines}
    assert len(losses) == 1
    # the ring crossed the process boundary: point-to-point hops
    assert all("'process': 3" in ln for ln in lines)


def test_launch_dryrun_kills_and_raises_on_timeout():
    with pytest.raises(RuntimeError, match="timed out"):
        multihost.launch_dryrun(2, 2, timeout_s=0.5)


def test_worker_failure_raises():
    with pytest.raises(RuntimeError, match="failed in process"):
        # one process of 3 ranks: dp x mp = 1 x 3 cannot split 32
        # classes, so the worker refuses the classifier split and exits
        # nonzero
        multihost.launch_dryrun(1, 3, timeout_s=120)
