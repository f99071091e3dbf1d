"""Fault 2's stress loop, on the card: the card calls of
``tests/test_torch_gpu.py::test_rnncell_card_equals_cpu[float32-RNN_TANH]``
(``forward`` and ``forward_train`` with ``target="cuda"``), then the CPU
``forward`` of the same case (RNN_TANH f32, N 37, C 50, K 70, T 4, seed 34),
many times over.

    python -m xsmm_tpu_torch.dnn.fault2_stress [--iters 500] [--procs 0]
        [--env NAME=VALUE ...] [--threads N] [--all-cells]

It counts the rounds whose CPU ``hs`` leaves the f64 numpy gold by more
than 1e-5 (rel-Frobenius), and the rounds whose CPU ``hs`` differs in any
bit from the first round's.  For each such round it prints first the
products that round's CPU call computed (its own x@W and each step's h@R,
kept by ``rnn_seq.keep_products``, not recomputed) against f64
(``products_report``), then which side and which rows are off
(``rnn_diagnosis``) and the two products recomputed and the first step's
tanh against f64 with MKL's and oneDNN's verbose lines (``cpu_products``).

``--all-cells`` makes each round the whole parametrized test: the card's
and then the CPU's ``forward`` and ``forward_train`` for every cell type
in f32 and bf16 on the same seed's inputs, the failing case among them in
its place.  ``--procs P`` runs the loop in P fresh processes, one after
the other, each with ``--iters`` rounds and with every ``--env`` setting
in its environment from its start (so that MKL and oneDNN read it when
torch loads them), and prints the sum; ``--procs 0`` runs it in this
process.  ``--threads`` sets ``torch.set_num_threads`` first.  The last
line is one JSON object with the counts.  It needs a CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N, C, K, T, SEED = 37, 50, 70, 4, 34
TOL = 1e-5


def case(gates: int = 1):
    """The failing test's inputs (numpy, from its seed) for a cell of
    ``gates`` gates."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((T, N, C)).astype(np.float32)
    w, r = ((rng.standard_normal(s) * 0.1).astype(np.float32)
            for s in ((C, gates * K), (K, gates * K)))
    b = rng.standard_normal(gates * K).astype(np.float32)
    h0, c0 = (rng.standard_normal((N, K)).astype(np.float32) * 0.1
              for _ in range(2))
    return x, w, r, b, h0, c0


def rel(got, want) -> float:
    import torch

    got, want = (torch.as_tensor(v).double().cpu() for v in (got, want))
    return (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want)).item()


def rnn_cell_gold(ct, x, w, r, b, h0, c0):
    """The cell's recurrence in numpy f64: hs, h_T and c_T (GRU and RNN
    return c0 as c_T)."""
    import numpy as np

    from .types import CellType

    x, w, r, b, h, c = (np.asarray(v, np.float64)
                        for v in (x, w, r, b, h0, c0))
    t, n, _ = x.shape
    k = h.shape[1]
    sig = lambda z: 1 / (1 + np.exp(-z))  # noqa: E731
    zx = (x.reshape(t * n, -1) @ w + b).reshape(t, n, -1)
    act = {CellType.RNN_RELU: lambda v: np.maximum(v, 0),
           CellType.RNN_SIGMOID: sig, CellType.RNN_TANH: np.tanh}.get(ct)
    hs = []
    for ti in range(t):
        if ct == CellType.LSTM:
            z = zx[ti] + h @ r
            i, g = sig(z[:, :k]), np.tanh(z[:, k:2 * k])
            f, o = sig(z[:, 2 * k:3 * k]), sig(z[:, 3 * k:])
            c = f * c + i * g
            h = o * np.tanh(c)
        elif ct == CellType.GRU:
            zr = h @ r
            ri = sig(zx[ti][:, :k] + zr[:, :k])
            zi = sig(zx[ti][:, k:2 * k] + zr[:, k:2 * k])
            gi = np.tanh(zx[ti][:, 2 * k:] + ri * zr[:, 2 * k:])
            h = (1 - zi) * gi + zi * h
        else:
            h = act(zx[ti] + h @ r)
        hs.append(h)
    return np.stack(hs), h, c


def staging_state() -> str:
    """The pinned staging pool of this process (``utils/scratch``): none, or
    its counts and the copies still on the link.  The failing case's
    inputs are below ``STAGE_MIN_BYTES``, so the pool is not on its path;
    this says whether it had run at all."""
    from ..utils import scratch

    pool = scratch._staging
    if pool is None:
        return "staging pool none"
    pending = sum(not ev.query() for ev in list(pool._in_flight.values()))
    return (f"staging pool {pool.nmallocs} buffers ({pool.nreuse} reuses), "
            f"{pool.nresults} result blocks, {pending} copies in flight")


def cpu_state() -> str:
    """The CPU's threads, its f32 matmul precision in both APIs, the
    autocast and determinism switches, and the staging pool."""
    import torch

    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError as e:  # the per-backend API was used
        legacy = f"unreadable ({str(e).splitlines()[0][:60]})"
    return (f"threads {torch.get_num_threads()}, f32 matmul precision "
            f"{legacy}, mkldnn matmul fp32_precision "
            f"{torch.backends.mkldnn.matmul.fp32_precision}, mkldnn "
            f"fp32_precision {torch.backends.mkldnn.fp32_precision}, cpu "
            f"autocast {torch.is_autocast_enabled('cpu')}, deterministic "
            f"{torch.are_deterministic_algorithms_enabled()}; "
            + staging_state())


def cpu_products(x, w, r, h0) -> str:
    """The RNN's two CPU products, x@W and h0@R (the port's full-f32
    ``_matmul``), against numpy f64, with oneDNN's and MKL's verbose output
    on, the first step's tanh against numpy's, and the CPU state."""
    import numpy as np
    import torch

    from ..ops.smm import _matmul

    t, n, c = x.shape
    xc, wc, rc, hc = (torch.from_numpy(np.ascontiguousarray(v)) for v in
                      (x.reshape(t * n, c), w, r, h0))
    with torch.backends.mkldnn.verbose(torch.backends.mkldnn.VERBOSE_ON), \
            torch.backends.mkl.verbose(torch.backends.mkl.VERBOSE_ON):
        zx, hr = _matmul(xc, wc), _matmul(hc, rc)
    errs = [rel(got, torch.from_numpy(a.astype(np.float64)
                                      @ b.astype(np.float64)))
            for got, (a, b) in ((zx, (xc.numpy(), w)), (hr, (h0, r)))]
    # tanh of the first step's argument (RNN_TANH), element by element
    # against numpy's f64 tanh of the same f32 values
    arg = zx[:n, :hr.shape[1]] + hr
    th = (torch.tanh(arg).double() - torch.from_numpy(
        np.tanh(arg.double().numpy()))).abs() / torch.from_numpy(
        np.abs(np.tanh(arg.double().numpy())) + 1e-30)
    bad = (th.max(dim=1).values > 1e-6).nonzero().flatten().tolist()
    return (f"cpu x@W vs f64 {errs[0]:.3e}, h0@R vs f64 {errs[1]:.3e}, "
            f"tanh worst relative {th.max().item():.3e} (rows beyond 1e-6: "
            f"{bad[:16]}); " + cpu_state())


# CPU flags under which oneDNN may run an f32 product at reduced precision
_ISA_FLAGS = ("amx_bf16", "amx_fp16", "amx_tile", "avx512_bf16",
              "avx512_fp16")


def cpu_isa() -> str:
    """Which of ``_ISA_FLAGS`` the host CPU reports (``/proc/cpuinfo``)."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln.split(":", 1)[1].split() for ln in f
                          if ln.startswith("flags")), [])
    except OSError as e:
        return f"cpu flags unreadable ({e})"
    have = [fl for fl in _ISA_FLAGS if fl in flags]
    return "cpu flags " + (" ".join(have) if have else "none of " +
                           " ".join(_ISA_FLAGS))


def precision_facts() -> str:
    """The facts that would rule in a product at reduced precision on the
    host: the ISA flags oneDNN may use, the f32 matmul precision (the
    legacy setting and oneDNN's fp32 precision where torch has it) and
    the thread count."""
    import torch

    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError as e:  # the per-backend API was used
        legacy = f"unreadable ({str(e).splitlines()[0][:60]})"
    mkl = getattr(torch.backends, "mkldnn", None)
    onednn = "; ".join(
        f"{name} {getattr(obj, 'fp32_precision', 'absent')}"
        for name, obj in (("mkldnn fp32_precision", mkl),
                          ("mkldnn matmul fp32_precision",
                           getattr(mkl, "matmul", None))))
    return (f"{cpu_isa()}; f32 matmul precision {legacy}; {onednn}; "
            f"threads {torch.get_num_threads()}")


def products_report(kept, label: str = "") -> str:
    """The products one call kept (``rnn_seq.keep_products``: its own x@W
    and each step's h@R, not recomputed), each against f64 from the same
    operands: rel-Frobenius, and the worst element with its index; a
    product beyond 1e-6 is marked OFF.  Ends with ``precision_facts``."""
    import torch

    parts = []
    steps = 0
    for name, a, b, out in kept:
        gold = a.double().cpu() @ b.double().cpu()
        d = (out.double().cpu() - gold).abs()
        err = (torch.linalg.vector_norm(d)
               / torch.linalg.vector_norm(gold)).item()
        idx = tuple(int(i) for i in divmod(int(d.argmax()), d.shape[1]))
        tag = name if name == "x@W" else f"{name} t{steps}"
        steps += name != "x@W"
        parts.append(f"{tag} {err:.3e}{' OFF' if err > 1e-6 else ''} "
                     f"(worst {idx}: {out.flatten()[int(d.argmax())].item()!r}"
                     f" vs {gold.flatten()[int(d.argmax())].item()!r})")
    return ((f"{label} call's own products vs f64: " + "; ".join(parts)
             if parts else f"{label} call kept no product")
            + "; " + precision_facts())


def rnn_diagnosis(name, card, cpu, gold) -> str:
    """Where the card and the CPU part on one tensor: each side's
    rel-Frobenius error against the f64 gold (the side further from it is
    the one that is off), the worst index and the three values there, the
    rows apart, and the CPU's state."""
    import numpy as np

    card, cpu = card.double().numpy(), cpu.double().numpy()
    idx = np.unravel_index(np.argmax(np.abs(card - cpu)), card.shape)
    axes = "(t, n, k)" if card.ndim == 3 else "(n, k)"
    e_card, e_cpu = (np.linalg.norm(v - gold) / np.linalg.norm(gold)
                     for v in (card, cpu))
    side = ("the card is off" if e_card > e_cpu else
            "the cpu is off" if e_cpu > e_card else "both as far off")
    # the rows (t, n) where the two part by more than f32 rounding
    off = np.abs(card - cpu).reshape(-1, card.shape[-1]).max(axis=1) > 1e-6
    return (f"{name}: card vs gold {e_card:.3e}, cpu vs gold {e_cpu:.3e} "
            f"({side}); worst {axes} = "
            f"{tuple(int(i) for i in idx)}: card {card[idx]!r}, cpu "
            f"{cpu[idx]!r}, gold {gold[idx]!r}; {int(off.sum())} rows apart "
            f"of {off.size}, first {np.flatnonzero(off).tolist()[:16]}; "
            + cpu_state())


def stress(iters: int, all_cells: bool = False) -> dict:
    """``iters`` rounds in this process; the counts."""
    import torch

    import xsmm_tpu_torch as xp

    from .rnn_seq import keep_products
    from .rnncell import create_rnncell
    from .types import CellType, RnnDesc

    x, w, r, b, h0, c0 = case()
    ct = CellType.RNN_TANH
    gold = torch.from_numpy(rnn_cell_gold(ct, x, w, r, b, h0, c0)[0])
    # (cell type, dtype) in the test's order; the failing case alone
    # without --all-cells
    combos = ([(c, d) for d in ("float32", "bfloat16") for c in CellType]
              if all_cells else [(ct, "float32")])
    cells = {}
    for c, d in combos:
        desc = RnnDesc(n=N, c=C, k=K, max_t=T, cell_type=c, in_dtype=d,
                       out_dtype=d)
        for target in ("cuda", "cpu"):
            xp.set_config(target=target)
            cells[(c, d, target)] = create_rnncell(desc)
    inputs = {g: case(g) for g in (1, 3, 4)}
    first = None
    off = differ = 0
    worst = 0.0
    for i in range(iters):
        for c, d in combos:
            args = inputs[{CellType.LSTM: 4, CellType.GRU: 3}.get(c, 1)]
            out = {}
            for target in ("cuda", "cpu"):
                xp.set_config(target=target)
                cell = cells[(c, d, target)]
                with keep_products() as kept:
                    out[target] = cell.forward(*args)[0]
                cell.forward_train(*args)
            if (c, d) == (ct, "float32"):
                card, cpu, cpu_kept = out["cuda"].cpu(), out["cpu"], kept
        err = rel(cpu, gold)
        worst = max(worst, err)
        if first is None:
            first = cpu.clone()
        new = not torch.equal(cpu, first)
        differ += new
        if err > TOL or new:
            off += err > TOL
            print(f"round {i}: cpu hs vs gold {err:.3e}"
                  f"{', differs from round 0' if new else ''}; "
                  + products_report(cpu_kept, "the cpu forward") + "; "
                  + rnn_diagnosis("forward hs", card, cpu, gold.numpy())
                  + "; " + cpu_products(x, w, r, h0), flush=True)
        torch.cuda.synchronize()
    xp.set_config(target="")
    return {"rounds": iters, "off": off, "differ": differ,
            "worst": worst}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--procs", type=int, default=0)
    ap.add_argument("--env", action="append", default=[],
                    help="NAME=VALUE in each fresh process's environment")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--all-cells", action="store_true")
    args = ap.parse_args()
    if args.procs:
        env = dict(os.environ)
        env.update(kv.split("=", 1) for kv in args.env)
        total = {"rounds": 0, "off": 0, "differ": 0, "worst": 0.0}
        for p in range(args.procs):
            cmd = [sys.executable, "-m", __spec__.name, "--iters",
                   str(args.iters)]
            if args.threads:
                cmd += ["--threads", str(args.threads)]
            if args.all_cells:
                cmd.append("--all-cells")
            out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                                 timeout=1800)
            lines = out.stdout.strip().splitlines()
            print("\n".join(lines[:-1]) + out.stderr[-2000:], flush=True)
            if out.returncode or not lines:
                raise RuntimeError(f"process {p} failed ({out.returncode})")
            got = json.loads(lines[-1])
            for key in ("rounds", "off", "differ"):
                total[key] += got[key]
            total["worst"] = max(total["worst"], got["worst"])
            total["procs_off"] = total.get("procs_off", 0) + bool(got["off"])
        total.update(procs=args.procs, env=args.env, threads=args.threads,
                     all_cells=args.all_cells)
        print(json.dumps(total))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("fault2_stress needs a CUDA card")
    if args.threads:
        torch.set_num_threads(args.threads)
    got = stress(args.iters, args.all_cells)
    got.update(threads=torch.get_num_threads(), pid=os.getpid(),
               env={k: os.environ[k] for k in sorted(os.environ)
                    if k.startswith(("MKL", "OMP", "ATEN", "ONEDNN", "DNNL"))})
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
