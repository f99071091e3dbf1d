"""Multi-process multi-host runs: the port of
``xsmm_tpu/parallel/multihost.py``.

SURVEY.md §4: the reference has no multi-node CI; the JAX package
simulates multi-host with ``jax.distributed`` multi-process CPU jobs (each
process one "host" with its own virtual devices).  Here each process is one
controller over its local ranks (``parallel/mesh.py``), and the processes
join through ``torch.distributed``:

* ``worker_main`` — the per-process body: joins the group (gloo, a
  ``tcp://`` address on a free port), builds a GLOBAL mesh over
  ``n_processes x local_devices`` ranks, and runs (a) the sharded train
  step (dp x mp: the batch on dp, the classifier's ``w``/``b``
  column-sharded over mp with the logits all-gathered, the rest
  replicated) and (b) the ring CSR SpMM (``dist_spmm.ring_spmm_csr``) —
  both therefore crossing PROCESS boundaries: the BN moments, the loss
  and the gradients are summed across processes, and ring hops between
  processes are ``torch.distributed`` point-to-point transfers.  On the
  card, processes that share one card join over gloo and every transfer
  is staged through host memory (``mesh.staged`` counts them);
* ``launch_dryrun`` — spawns N such processes and fails loudly if any
  worker fails or the run outlasts its timeout (every worker is killed).

Run directly:  python -m xsmm_tpu_torch.parallel.multihost PID N ADDR L DEV
(``launch_dryrun`` does).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch


def dp_mp_train_step(mesh, classes: int = 32, width: int = 8,
                     batch: Optional[int] = None, hw: int = 32,
                     seed: int = 0, lr: float = 0.01) -> dict:
    """One SGD step of ResNet-18 (width ``width``) over a (dp, mp) mesh,
    then an eval pass on the new running statistics.

    The batch lies on dp (every process draws the global batch from
    ``seed`` and keeps its dp rows' shards: per-host data feeding), the
    classifier's ``w`` and ``b`` are column-sharded over mp (the logits
    all-gathered over mp), the rest replicated.  The graph runs in
    lock-step over the local ranks; the loss is the mean over every rank;
    each parameter's gradient is the sum over its replicas (over dp and mp,
    or over dp for the classifier's shards).  Returns the loss (every
    process's), the first BN's ``scf``, whether the eval logits are finite
    and the local ranks' updated parameters (``params``, the classifier's
    shards among them)."""
    import torch.distributed as dist

    from ..dnn.layers import Ranks
    from ..models import resnet
    from ..models.engine import softmax_xent, tree_flatten_with_path, \
        tree_map
    from .mesh import psum

    dp, mp = mesh.shape["dp"], mesh.shape["mp"]
    if classes % mp:
        raise ValueError(f"{classes} classes do not split over mp = {mp}")
    batch = batch or 2 * dp
    local = mesh.local_ranks()
    params, forward = resnet(depth=18, num_classes=classes, width=width,
                             input_shape=(batch, hw, hw, 3), seed=seed)
    cols = classes // mp
    reps, states = [], []
    for r in local:
        dev = mesh.device(r)

        def own(t, _d=dev):
            t = t.detach().to(_d).clone()
            return t.requires_grad_() if t.is_floating_point() else t
        layers = tree_map(own, params["layers"])
        j = mesh.coord(r, "mp")
        fc = layers[-1]
        fc["w"] = fc["w"].detach()[:, j * cols:(j + 1) * cols].clone() \
            .requires_grad_()
        fc["b"] = fc["b"].detach()[j * cols:(j + 1) * cols].clone() \
            .requires_grad_()
        reps.append({"layers": layers})
        states.append(tree_map(lambda t, _d=dev: t.to(_d).clone(),
                               dict(forward.init_state)))
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, hw, hw, 3), generator=gen)
    y = torch.randint(0, classes, (batch,), generator=gen)
    bs = batch // dp
    xs = Ranks([x[mesh.coord(r, "dp") * bs:(mesh.coord(r, "dp") + 1) * bs]
                .to(mesh.device(r)) for r in local], mesh)
    ys = [y[mesh.coord(r, "dp") * bs:(mesh.coord(r, "dp") + 1) * bs]
          .to(mesh.device(r)) for r in local]
    with torch.enable_grad():
        logits, new_states = forward(Ranks(reps), xs, train=True,
                                     state=states)
        losses = [softmax_xent(lg, yy) for lg, yy in zip(logits, ys)]
        total = losses[0]
        for lv in losses[1:]:
            total = total + lv.to(total.device)
        total = total / mesh.size
    leaves = [[t for k, t in tree_flatten_with_path(p)] for p in reps]
    keys = [k for k, _ in tree_flatten_with_path(reps[0])]
    n = len(keys)
    grads = torch.autograd.grad(total, [t for ls in leaves for t in ls])
    shard = [k.startswith(f"['layers'][{len(reps[0]['layers']) - 1}]")
             for k in keys]
    with torch.no_grad():
        # one flat vector a rank for the replicated leaves (summed over dp
        # and mp) and one for the classifier's shards (summed over dp)
        summed = [[None] * n for _ in local]
        for want, axes in ((False, ("dp", "mp")), (True, ("dp",))):
            idx = [i for i in range(n) if shard[i] == want]
            vecs = [torch.cat([grads[ri * n + i].reshape(-1) for i in idx])
                    for ri in range(len(local))]
            for ri, v in enumerate(psum(mesh, axes, vecs)):
                off = 0
                for i in idx:
                    m = leaves[ri][i].numel()
                    summed[ri][i] = v[off:off + m].view_as(leaves[ri][i])
                    off += m
        for ri in range(len(local)):
            for p, g in zip(leaves[ri], summed[ri]):
                p.sub_(lr * g)
        loss = total.detach().cpu().double()
        if mesh.spans_processes():
            dist.all_reduce(loss)
        eval_logits, _ = forward(Ranks(reps), xs, train=False,
                                 state=new_states)
        finite = all(bool(torch.isfinite(lg).all()) for lg in eval_logits)
    return {"loss": float(loss), "scf": float(new_states[0]["bn0"].scf),
            "eval_finite": finite,
            "eval_shape": tuple(eval_logits[0].shape), "params": reps}


def ring_check(mesh, m: int = 48, n: int = 128, seed: int = 0) -> float:
    """``ring_spmm_csr`` over the mesh's "mp" ring on an m x 8d operator of
    density 0.2 from ``seed``: the rel-Frobenius error of C against the f64
    product, summed over every process's rows."""
    import torch.distributed as dist

    from . import dist_spmm

    d = mesh.shape["mp"]
    rng = np.random.default_rng(seed)
    k = 8 * d
    a = np.where(rng.random((m, k)) < 0.2,
                 rng.standard_normal((m, k)), 0.0).astype(np.float32)
    b = torch.randn((k, n), generator=torch.Generator().manual_seed(seed + 1))
    fn = dist_spmm.ring_spmm_csr(mesh, a, n, dtype="float32")
    c = fn(dist_spmm.shard_rows(mesh, b))
    ref = a.astype(np.float64) @ b.double().numpy()
    ml = -(-m // d)
    sums = np.zeros(2)
    for r, t in zip(mesh.local_ranks(), c.shards):
        if mesh.coord(r, "dp"):
            continue             # the other dp rows repeat the ring
        e = mesh.coord(r, "mp")
        rows = ref[e * ml:min((e + 1) * ml, m)]
        got = t.detach().double().cpu().numpy()[:len(rows)]
        sums += [((got - rows) ** 2).sum(), (rows ** 2).sum()]
    tot = torch.from_numpy(sums)
    if mesh.spans_processes():
        dist.all_reduce(tot)
    return float(np.sqrt(tot[0] / tot[1]))


def worker_main(process_id: int, num_processes: int, init_method: str,
                local_devices: int, device: str = "cpu") -> None:
    """One process of the dryrun: ``local_devices`` ranks on ``device``
    ("cpu", or "cuda" for ranks on the card, cards shared round robin)."""
    import torch.distributed as dist

    import xsmm_tpu_torch as xp

    from .mesh import global_mesh, init_multihost

    torch.set_num_threads(1)
    if device == "cpu":
        xp.set_config(target="cpu")
        devs = ["cpu"] * local_devices
    else:
        cards = torch.cuda.device_count()
        devs = [f"cuda:{(process_id * local_devices + i) % cards}"
                for i in range(local_devices)]
    init_multihost(init_method, num_processes, process_id, devs)
    assert dist.get_world_size() == num_processes
    n_global = num_processes * local_devices

    # ---- (a) sharded train step across process boundaries ----------------
    dp = max(1, n_global // 2)
    mp = n_global // dp
    mesh = global_mesh((dp, mp), ("dp", "mp"), devs)
    step = dp_mp_train_step(mesh, classes=32, width=8, batch=2 * dp)
    assert np.isfinite(step["loss"]), f"non-finite loss {step['loss']}"
    assert step["scf"] == 1.0, f"running stats did not update: {step['scf']}"
    assert step["eval_finite"], "non-finite eval logits"

    # ---- (b) ring CSR SpMM over the cross-process ring -------------------
    ring = global_mesh((1, n_global), ("dp", "mp"), devs)
    err = ring_check(ring)
    assert err < 1e-3, f"ring CSR SpMM err {err}"

    from . import dist_spmm
    from .mesh import staged
    print(f"[proc {process_id}] multihost dryrun OK: {num_processes} "
          f"processes x {local_devices} ranks on {device}, backend "
          f"{dist.get_backend()}, loss={step['loss']:.4f}, "
          f"ring_err={err:.2e}, hops {dist_spmm.hops}, staged "
          f"{staged}", flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_dryrun(n_processes: int = 2, local_devices: int = 4,
                  timeout_s: float = 600.0, port: int = 0,
                  device: Optional[str] = None) -> List[str]:
    """Spawn ``n_processes`` workers (this module as __main__) and join
    them; kill every worker and raise on a timeout or a nonzero exit.
    ``device``: "cpu" or "cuda" (default: the entry points' target).
    Prints and returns each worker's OK line."""
    from ..core import platform

    device = device or ("cpu" if platform.backend() == "cpu" else "cuda")
    init_method = f"tcp://127.0.0.1:{port or free_port()}"
    env = dict(os.environ)
    env["XSMM_COMM_TIMEOUT_S"] = str(max(10.0, timeout_s / 2))
    env["OMP_NUM_THREADS"] = "1"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "xsmm_tpu_torch.parallel.multihost",
         str(pid), str(n_processes), init_method, str(local_devices),
         device], env=env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(n_processes)]
    deadline = time.time() + timeout_s
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"multihost dryrun timed out after {timeout_s} s")
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            "multihost dryrun failed in process(es) "
            f"{bad}:\n" + "\n".join(outs[i][-3000:] for i in bad))
    lines = [ln for o in outs for ln in o.splitlines()
             if "multihost dryrun OK" in ln]
    for ln in lines:
        print(ln)
    return lines


if __name__ == "__main__":
    worker_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                int(sys.argv[4]), sys.argv[5] if len(sys.argv) > 5 else "cpu")
