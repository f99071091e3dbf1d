"""Entry points for a compile check and the distributed dryruns: the analog
of the repository's ``__graft_entry__.py`` (its lines 18-161) inside the
port package.

entry() -> (fn, example_args): the forward of the flagship model
(ResNet-18 width 16 from the GxM-analog zoo, built on the framework's DNN
layers) and its inputs.

dryrun_multichip(n): one training step (loss, gradients, SGD update) of
ResNet-18 over an n-rank dp x mp mesh — the batch on dp, the classifier
tensor-parallel on mp (its logits all-gathered), the rest replicated —
then an eval pass and the dense ring SpMM over an n-rank ring.  Ranks
beyond the cards share them (virtual ranks, as the JAX package's virtual
CPU devices); on the CPU target every rank is the CPU.

dryrun_multihost(n, l): the same across ``n`` processes of ``l`` ranks
each (``parallel/multihost.launch_dryrun``).

Everything runs on the card unless the target is the CPU
(``XSMM_TARGET=cpu``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import platform


def entry():
    """Returns (fn, example_args): the flagship forward step."""
    from .models import resnet

    params, forward = resnet(depth=18, num_classes=100, width=16)
    dev = platform.device()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((8, 32, 32, 3), generator=gen, device=dev)
    meta = {k: v for k, v in params.items() if k.startswith("_")}
    train = {k: v for k, v in params.items() if not k.startswith("_")}

    def fn(p, xb):
        return forward({**p, **meta}, xb)

    return fn, (train, x)


def dryrun_multichip(n_devices: int) -> dict:
    """One sharded train step on tiny shapes over an n-rank mesh; asserts a
    finite loss, the BN running statistics updated once (scf == 1) and
    finite eval logits, then the ring SpMM's output finite.  Returns the
    step's numbers."""
    from .parallel import dist_spmm
    from .parallel.mesh import make_mesh, virtual_devices
    from .parallel.multihost import dp_mp_train_step

    devices = virtual_devices(n_devices)
    dp = max(1, n_devices // 2) if n_devices > 1 else 1
    mp = n_devices // dp
    mesh = make_mesh((dp, mp), ("dp", "mp"), devices=devices)
    step = dp_mp_train_step(mesh, classes=64, width=8, batch=4 * dp)
    assert np.isfinite(step["loss"]), f"non-finite loss: {step['loss']}"
    assert step["scf"] == 1.0, \
        f"running stats did not update: scf={step['scf']}"
    assert step["eval_finite"], "non-finite eval logits"

    # the ring-collective path: row-partitioned dense SpMM with rotating
    # B panels (parallel/dist_spmm.py)
    ring = make_mesh((1, n_devices), ("dp", "mp"), devices=devices)
    gen = torch.Generator().manual_seed(2)
    a = torch.randn((8 * n_devices, 8 * n_devices), generator=gen)
    b = torch.randn((8 * n_devices, 16), generator=gen)
    c = dist_spmm.ring_spmm(ring)(dist_spmm.shard_rows(ring, a),
                                  dist_spmm.shard_rows(ring, b)).gather()
    assert bool(torch.isfinite(c).all()), "ring spmm produced non-finite"
    err = float((c.double().cpu() - a.double() @ b.double()).norm()
                / (a.double() @ b.double()).norm())
    step.update(ring_err=err, mesh=dict(mesh.shape))
    del step["params"]
    return step


def dryrun_multihost(n_processes: int = 2, local_devices: int = 4,
                     timeout_s: float = 600.0):
    """Multi-PROCESS multi-host run (SURVEY §4's noarch analog for
    multi-node): ``n_processes`` processes join over ``torch.distributed``
    and run the sharded train step and the cross-process ring CSR SpMM;
    returns each worker's OK line."""
    from .parallel.multihost import launch_dryrun

    return launch_dryrun(n_processes, local_devices, timeout_s)


if __name__ == "__main__":
    import os
    import sys

    fn, args = entry()
    print("entry() OK:", tuple(fn(*args).shape))
    n = int(sys.argv[1]) if len(sys.argv) > 1 else int(
        os.environ.get("XSMM_DRYRUN_DEVICES", 4))
    print(f"dryrun_multichip({n}) OK:", dryrun_multichip(n))
