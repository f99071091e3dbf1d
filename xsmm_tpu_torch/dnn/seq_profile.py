"""Where the time of the RNN sequence kernels goes, on the card.

    python -m xsmm_tpu_torch.dnn.seq_profile [--shape 128,512,512,32]
        [--variant base] [--variant RB=8] [--variant THREADS=256,RM=2]
        [--direction fwd|bwd|both]

For every variant (``base`` is ``ops/csrc/rnn_seq.cu`` as it is; any other
is a comma-separated list of ``NAME=VALUE`` that rewrites the source's
``constexpr int NAME = ...;``) this builds two copies of the source into
``xsmm_tpu_torch/build/seq_profile/``: one as it is, and one with
``clock64()`` stamps at the phases of every step, taken by thread 0 of every
block.  Then, at N, C, K, T = ``--shape`` for the LSTM, GRU and simple-RNN
kernels in f32 and bf16, it

* times each variant's kernel with CUDA events, the variants in turns
  (a, b, ..., b, a), and holds its output against the plain version;
* prints the mean time of each phase of a step over blocks and steps
  (``pre``: the epilogue's operands and the first h chunk put in flight;
  ``product``: the h@R loop over all chunks; ``epi``: the gate epilogue;
  ``barrier``: the grid barrier), and the one-time load of the R slice,
  at the card's peak SM clock.

``--direction bwd`` does the same for the backward kernels (``product``:
dz @ R^T over all chunks and the warps' sum; ``epi``: the gate-gradient
epilogue), on random residuals with dz in R's dtype; ``both`` runs the two.

It needs a CUDA card and nvcc, and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path
from typing import Dict, List

from ..ops import cuda_build

SOURCE = Path(cuda_build.__file__).resolve().parent / "csrc" / "rnn_seq.cu"
OUT_DIR = cuda_build.BUILD_DIR / "seq_profile"
STAMPS = 512 * 64 * 8   # blocks x steps x phases kept

# (anchor in rnn_seq.cu, text inserted before it)
_STAMPS = [
    ("  // -- the block's R slice, once",
     "  if (threadIdx.x == 0) g_start[blockIdx.x * 2] = clock64();\n"),
    ("  const int row0 = rbi * p.passes * ROWS;\n",
     "  if (threadIdx.x == 0) g_start[blockIdx.x * 2 + 1] = clock64();\n"),
    ("    const float* hin = t == 0 ? p.h0", "    STAMP(t, 0);\n"),
    ("      for (int k0 = 0; k0 < p.kr; k0 += KT) {\n", "      STAMP(t, 1);\n"),
    ("      // -- the gate epilogue", "      STAMP(t, 2);\n"),
    ("    if (!last) grid_barrier(p.bar", "    STAMP(t, 3);\n"),
]
_AFTER_BARRIER = "    if (!last) grid_barrier(p.bar, (unsigned)(t + 1) * gridDim.x);\n"
# the backward kernel's, indexed by its step s (t = T-1-s)
_BWD_STAMPS = [
    ("  // -- R^T's columns j0 .. j0+15",
     "  if (threadIdx.x == 0) g_start[blockIdx.x * 2] = clock64();\n"),
    ("  const int first_row = rbi * p.passes * BROWS;\n",
     "  if (threadIdx.x == 0) g_start[blockIdx.x * 2 + 1] = clock64();\n"),
    ("    const RT* xin = static_cast<const RT*>(p.xbuf)", "    STAMP(s, 0);\n"),
    ("      // -- dh_prev = dz_{t+1} @ R^T", "      STAMP(s, 1);\n"),
    ("      if (t < 0) {  // the last product: dh0", "      STAMP(s, 2);\n"),
    ("    if (t == 0) {  // the block's partial sums of db", "    STAMP(s, 3);\n"),
]
_BWD_AFTER_BARRIER = ("    if (t >= 0) grid_barrier(p.bar, (unsigned)(s + 1) * "
                      "gridDim.x);\n")
_HEAD = """namespace {
__device__ long long g_prof[%d];
__device__ long long g_start[1024];
#define STAMP(t, i) if (threadIdx.x == 0 && (t) < 64) \\
  g_prof[(blockIdx.x * 64 + (t)) * 8 + (i)] = clock64();
""" % STAMPS
_TAIL = """
extern "C" int xsmm_prof_read(long long* prof, long long* start) {
  cudaMemcpyFromSymbol(prof, g_prof, sizeof(g_prof));
  return (int)cudaMemcpyFromSymbol(start, g_start, sizeof(g_start));
}
extern "C" int xsmm_prof_zero(const long long* zeros) {
  cudaMemcpyToSymbol(g_prof, zeros, sizeof(g_prof));
  return (int)cudaMemcpyToSymbol(g_start, zeros, sizeof(g_start));
}
"""


def apply_settings(src: str, settings: Dict[str, int]) -> str:
    """``src`` with ``constexpr int NAME = old;`` set to each new value."""
    for name, value in settings.items():
        head = f"constexpr int {name} = "
        if src.count(head) != 1:
            raise ValueError(f"no single 'constexpr int {name}' in the source")
        i = src.index(head) + len(head)
        src = src[:i] + str(value) + src[src.index(";", i):]
    return src


def instrument(src: str) -> str:
    """``src`` with the clock64() stamps and the entry points that read them
    (raises if an anchor is gone from the source)."""
    stamps = _STAMPS + _BWD_STAMPS
    for anchor, _ in stamps + [("namespace {\n", "")]:
        if src.count(anchor) != 1:
            raise ValueError(f"anchor not found once in rnn_seq.cu: {anchor!r}")
    src = src.replace("namespace {\n", _HEAD, 1)
    for anchor, text in stamps:
        src = src.replace(anchor, text + anchor)
    for line, step in ((_AFTER_BARRIER, "t"), (_BWD_AFTER_BARRIER, "s")):
        if src.count(line) != 1:
            raise ValueError("a grid barrier's call is gone from rnn_seq.cu")
        src = src.replace(line, line + f"    STAMP({step}, 4);\n")
    return src + _TAIL


def parse_variant(text: str) -> Dict[str, int]:
    if text == "base":
        return {}
    return {k.strip(): int(v) for k, v in
            (item.split("=") for item in text.split(","))}


def build(variants: List[str]) -> Dict[tuple, ctypes.CDLL]:
    """(variant, "plain" | "prof") -> loaded library; one nvcc each, all
    started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    base = SOURCE.read_text()
    procs = {}
    for i, v in enumerate(variants):
        src = apply_settings(base, parse_variant(v))
        for kind, text in (("plain", src), ("prof", instrument(src))):
            cu = OUT_DIR / f"v{i}_{kind}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                   str(so), str(cu)]
            procs[(v, kind)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        out, _ = proc.communicate(timeout=cuda_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import numpy as np
    import torch

    from . import rnn_seq as rs
    from ..utils.timer import cuda_time_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="128,512,512,32", help="N,C,K,T")
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--direction", choices=("fwd", "bwd", "both"),
                    default="fwd")
    args = ap.parse_args()
    variants = args.variant or ["base"]
    if not torch.cuda.is_available():
        raise RuntimeError("seq_profile needs a CUDA card")
    n, _, k, t = (int(v) for v in args.shape.split(","))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    clock_ghz = torch.cuda.get_device_properties(0).clock_rate / 1e6 \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") else 1.98
    libs = build(variants)

    def use(lib):
        cuda_build._LIBS["rnn_seq"] = lib
        rs._LIB = None
        rs._fits.cache_clear()
        rs._lib()

    g = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def fwd_case(cell, gates, rdt):
        zx = randn(t, n, gates * k)
        r = (randn(k, gates * k) * 0.1).to(rdt)
        h0, c0 = randn(n, k) * 0.1, randn(n, k) * 0.1

        def run(plain=False):
            sfx = "_plain" if plain else ""
            if cell == "lstm":
                return getattr(rs, "lstm_seq" + sfx)(zx, r, h0, c0,
                                                     train=False)
            if cell == "gru":
                return getattr(rs, "gru_seq" + sfx)(zx, r, h0, train=False)
            return getattr(rs, "rnn_seq" + sfx)(zx, r, h0, act="tanh")
        return run

    def bwd_case(cell, gates, rdt):
        """Random residuals in their ranges, R^T scaled to keep dh bounded,
        dz in R's dtype (as the cell emits it)."""
        dhs = randn(t, n, k)
        if gates == 4:
            res = [torch.sigmoid(randn(t, n, k)), torch.tanh(randn(t, n, k)),
                   torch.sigmoid(randn(t, n, k)),
                   torch.sigmoid(randn(t, n, k)), randn(t, n, k)]
        elif gates == 3:
            res = [torch.sigmoid(randn(t, n, k)),
                   torch.sigmoid(randn(t, n, k)), torch.tanh(randn(t, n, k)),
                   randn(t, n, k), torch.tanh(randn(t, n, k))]
        else:
            res = [torch.tanh(randn(t, n, k))]
        states = [randn(n, k) * 0.5 for _ in range(gates == 4 and 3 or 2)]
        rt = (randn(gates * k, k) / k ** 0.5).to(rdt).contiguous()

        def run(plain=False):
            sfx = "_plain" if plain else ""
            kw = {"act": "tanh"} if cell == "rnn" else {}
            ops = ([dhs, *res, *states] if cell != "rnn"
                   else [dhs, *res, states[0]])
            return getattr(rs, f"{cell}_seq_bwd{sfx}")(*ops, rt, dz_dt=rdt,
                                                       **kw)
        return run

    zeros = np.zeros(STAMPS, np.int64)
    print(f"N{n} K{k} T{t}; SM clock taken as {clock_ghz:.2f} GHz; "
          f"{torch.cuda.get_device_name(0)}")
    dirs = ("fwd", "bwd") if args.direction == "both" else (args.direction,)
    for direction in dirs:
        for cell, gates in (("lstm", 4), ("gru", 3), ("rnn", 1)):
            for rdt in (torch.float32, torch.bfloat16):
                run = (fwd_case if direction == "fwd" else bwd_case)(
                    cell, gates, rdt)
                want = run(plain=True)
                ms: Dict[str, list] = {v: [] for v in variants}
                checks = {}
                for v in variants + variants[::-1]:
                    use(libs[(v, "plain")])
                    got = run()
                    torch.cuda.synchronize()
                    checks[v] = (max((torch.linalg.vector_norm(
                        (a - b).double()) / torch.linalg.vector_norm(
                            b.double())).item() for a, b in zip(got, want)),
                        all(torch.equal(a, b) for a, b in zip(got, want)))
                    ms[v].append(cuda_time_ms(run, warmup=3, iters=20))
                print(f"{direction} {cell} {str(rdt).removeprefix('torch.')} "
                      f"(turns {' '.join(variants + variants[::-1])})")
                for v in variants:
                    lib = libs[(v, "prof")]
                    use(lib)
                    lib.xsmm_prof_zero.argtypes = [ctypes.c_void_p]
                    lib.xsmm_prof_read.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_void_p]
                    lib.xsmm_prof_zero(zeros.ctypes.data)
                    run()
                    torch.cuda.synchronize()
                    prof = np.zeros(STAMPS, np.int64)
                    start = np.zeros(1024, np.int64)
                    lib.xsmm_prof_read(prof.ctypes.data, start.ctypes.data)
                    grid = int((start[1::2] > 0).sum())
                    # the steps with every phase: the forward's all but the
                    # last (no barrier); the backward's s = 1 .. T-1 (s = 0
                    # has no product, s = T only dh0's)
                    steps = (slice(0, min(t, 64)) if direction == "fwd"
                             else slice(1, min(t, 64)))
                    p = prof.reshape(512, 64, 8)[:grid, steps].astype(
                        np.float64) / (clock_ghz * 1e3)
                    phases = {"pre": p[:, :, 1] - p[:, :, 0],
                              "product": p[:, :, 2] - p[:, :, 1],
                              "epi": p[:, :, 3] - p[:, :, 2],
                              "barrier": p[:, :-1, 4] - p[:, :-1, 3]}
                    r_us = ((start[1::2] - start[0::2])[:grid]
                            / (clock_ghz * 1e3)).mean()
                    err, exact = checks[v]
                    print(f"  {v:18s} "
                          f"{' / '.join('%.4f' % m for m in ms[v])} ms "
                          f"({min(ms[v]) * 1e3 / t:.2f} us/step); vs plain "
                          f"{err:.2e}{' bit-exact' if exact else ''}; grid "
                          f"{grid}; R slice {r_us:.1f} us; " + ", ".join(
                              f"{name} {v_.mean():.2f}" for name, v_ in
                              phases.items() if v_.size) + " us a step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
