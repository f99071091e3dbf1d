"""Fault 3's step and its diagnostics: one ResNet-18 training step (width
64, 100 classes, 8x64x64, f32, a ``template_batches`` batch) through
``MLEngine`` on the card and with ``target="cpu"``, each card step held to
the CPU's at the repo's 1e-3 gate on every parameter's update.

    python -m xsmm_tpu_torch.models.fault3_stress [--repeats 50] [--seed 0]
        [--log chiprun_out/fault3.log]

It runs the CPU's step twice and the card's ``--repeats`` times on cuDNN's
default algorithms, each card step under ``torch.profiler``, and counts the
card steps whose worst update leaves the CPU's by more than 1e-3
(rel-Frobenius).  For every step it writes to the log the loss, the worst
leaf by name beside its rel-Frobenius, and the kernels that cuDNN ran for
each convolution, forward and backward (the kernel names carry the
algorithm: implicit GEMM, Winograd, FFT, ``wgrad_alg0`` ...), beside the
``torch.backends.cudnn`` state and the host's precision facts.  The last
line is one JSON object with the counts.  It needs a CUDA card and imports
nothing of JAX.  ``chip_smoke.py``'s step 32 runs the same step.
"""

from __future__ import annotations

import argparse
import json
import os
import time

SHAPE = (8, 64, 64, 3)
CLASSES = 100
LOSS_TOL = 1e-5
UPDATE_TOL = 1e-3
STATE_TOL = 1e-4
# the ops under which cuDNN launches a convolution's kernels
_CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
             "aten::convolution_backward")


def batch(seed: int = 0):
    """The step's batch (numpy), as step 32 draws it."""
    from .engine import template_batches

    return next(template_batches(1, SHAPE[0], hw=SHAPE[1], classes=CLASSES,
                                 seed=seed))


def cudnn_state() -> str:
    import torch

    b = torch.backends
    return (f"cudnn {b.cudnn.version()} enabled {b.cudnn.enabled} "
            f"benchmark {b.cudnn.benchmark} deterministic "
            f"{b.cudnn.deterministic} allow_tf32 {b.cudnn.allow_tf32}; "
            f"cuBLAS allow_tf32 {b.cuda.matmul.allow_tf32}")


def conv_kernels(prof):
    """The kernels of each convolution op of a profiled step, in the order
    the step ran them: [("fwd" | "bwd", op name, [kernel name, ...]),
    ...], "bwd" for the ops that autograd's backward ran."""
    from torch.autograd import DeviceType

    def kernels(e):
        return ([k.name for k in e.kernels]
                + [n for c in e.cpu_children for n in kernels(c)])

    def inside(e, pred):
        e = e.cpu_parent
        while e is not None:
            if pred(e):
                return True
            e = e.cpu_parent
        return False

    out = []
    for e in prof.events():
        if (e.device_type != DeviceType.CPU or e.name not in _CONV_OPS
                or inside(e, lambda p: p.name in _CONV_OPS)):
            continue
        bwd = inside(e, lambda p: getattr(p, "scope", 0) == 1) or \
            getattr(e, "scope", 0) == 1
        out.append(("bwd" if bwd else "fwd", e.name, kernels(e)))
    return out


def step(target: str, x, y, seed: int = 0, deterministic: bool = False,
         profile: bool = False) -> dict:
    """One ResNet-18 step of a fresh engine on ``target``: the loss, each
    leaf's update by name, the BN state, the seconds, and (``profile``,
    card only) each convolution's kernels."""
    import torch

    import xsmm_tpu_torch as xp

    from . import MLEngine, SolverConfig, resnet
    from .engine import tree_flatten_with_path

    xp.set_config(target=target)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    convs = None
    try:
        params, fwd = resnet(18, width=64, num_classes=CLASSES,
                             input_shape=SHAPE, seed=seed)
        before = [t.detach().double().cpu() for _, t in
                  tree_flatten_with_path(params["layers"])]
        eng = MLEngine(params, fwd, SolverConfig(lr=0.05))
        t0 = time.perf_counter()
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_
            with prof_(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                loss = eng.train_epoch(iter([(x, y)]), verbose=False)["loss"]
                torch.cuda.synchronize()
            convs = conv_kernels(prof)
        else:
            loss = eng.train_epoch(iter([(x, y)]), verbose=False)["loss"]
        step_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = saved
        xp.set_config(target="cuda")
    upd = {k: t.detach().double().cpu() - b for (k, t), b in
           zip(tree_flatten_with_path(eng.params), before)}
    state = [t.double().cpu() for _, t in tree_flatten_with_path(eng.state)]
    return {"loss": loss, "updates": upd, "state": state, "seconds": step_s,
            "convs": convs}


def diff(a: dict, b: dict):
    """(loss rel, worst leaf's update rel-Frobenius, its name, BN state max
    abs) of two ``step`` results, b the reference."""
    import torch

    rels = {k: (torch.linalg.vector_norm(u - b["updates"][k])
                / torch.linalg.vector_norm(b["updates"][k])).item()
            for k, u in a["updates"].items()}
    worst = max(rels, key=rels.get)
    return (abs(a["loss"] - b["loss"]) / abs(b["loss"]), rels[worst], worst,
            max((u - v).abs().max().item()
                for u, v in zip(a["state"], b["state"])))


def passes(e) -> bool:
    return e[0] <= LOSS_TOL and e[1] <= UPDATE_TOL and e[3] <= STATE_TOL


def describe(i: int, s: dict, e) -> str:
    """One step's log entry: its reading against the CPU's, the worst leaf
    and each convolution's kernels."""
    lines = [f"card step {i}: loss {s['loss']:.7f} rel {e[0]:.3e}, worst "
             f"update rel-Frobenius {e[1]:.3e} at {e[2]}, BN state max abs "
             f"{e[3]:.3e} {'pass' if passes(e) else 'FAIL'}"]
    for j, (kind, op, names) in enumerate(s["convs"] or []):
        lines.append(f"  conv op {j} {kind} {op}: " + " | ".join(names))
    return "\n".join(lines)


def write_log(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=os.path.join("chiprun_out",
                                                  "fault3.log"))
    args = ap.parse_args()
    import torch

    from ..dnn.fault2_stress import precision_facts

    if not torch.cuda.is_available():
        raise RuntimeError("fault3_stress needs a CUDA card")
    x, y = batch(args.seed)
    cpu = [step("cpu", x, y, args.seed) for _ in range(2)]
    head = [f"{torch.cuda.get_device_name(0)}; {cudnn_state()}; host "
            f"{precision_facts()}",
            f"cpu repeat against the first (loss, update, leaf, state): "
            f"{diff(cpu[1], cpu[0])}"]
    log, over, worst = [], 0, (0.0, 0.0, "", 0.0)
    for i in range(args.repeats):
        s = step("cuda", x, y, args.seed, profile=True)
        e = diff(s, cpu[0])
        over += e[1] > UPDATE_TOL
        worst = max(worst, e, key=lambda v: v[1])
        log.append(describe(i, s, e))
        print(log[-1].splitlines()[0], flush=True)
    write_log(args.log, "\n".join(head + log) + "\n")
    print(json.dumps({"repeats": args.repeats, "above_gate": over,
                      "gate": UPDATE_TOL, "worst": worst[1],
                      "worst_leaf": worst[2], "log": args.log}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
