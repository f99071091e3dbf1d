"""Where the time of the RNN sequence kernels goes, on the card.

    python -m xsmm_tpu_torch.dnn.seq_profile [--shape 128,512,512,32 ...]
        [--variant base] [--variant RB=8] [--variant THREADS=256,RM=2]
        [--variant src=PATH] [--direction fwd|bwd|both]

For every variant (``base`` is ``ops/csrc/rnn_seq.cu`` as it is; ``src=PATH``
is another copy of that source, e.g. a parent tree's, whose entry points
take the same arguments; any other is a comma-separated list of
``NAME=VALUE`` that rewrites the source's ``constexpr int NAME = ...;``)
this builds two copies of the source into
``xsmm_tpu_torch/build/seq_profile/``: one as it is, and one with
``clock64()`` stamps at the phases of every step, taken by thread 0 of every
block (a ``src=`` copy whose anchors differ is timed without stamps; one
without ``xsmm_rnn_seq_bwd_scratch``, from before the row-chunked backward,
gets it with the first backward design's scratch sizes, and one from before
the forward's forms a form query of zeros and entry points that take the
form's pointer).  Then, at each N, C, K, T = ``--shape`` (one build serves
them all) for the LSTM, GRU and simple-RNN kernels in f32 and bf16,
it

* times each variant's kernel with CUDA events, the variants in turns
  (a, b, ..., b, a), and holds its output against the plain version;
* prints the mean time of each phase of a step over blocks and steps
  (``pre``: the epilogue's operands and the first h chunk put in flight;
  ``product``: the h@R loop over all chunks, of which ``staging``: the h
  chunks' two block barriers and stores, summed; ``epi``: the gate
  epilogue (the split form's partial sums too);
  ``barrier``: the grid barrier), and the one-time load of the R slice,
  at the card's peak SM clock.

``--direction bwd`` does the same for the backward kernels, on random
residuals with dz in R's dtype, with the phases ``barrier`` (the grid
barrier before the step), ``reduction`` (the column blocks' partials of dh
loaded and added in order), ``epi`` (the gate-gradient epilogue, the dz
tile and db's sums), ``product`` (the block's partial of dh_{t-1} and its
stores) and ``store`` (the stores alone), in the first pass of the first
row chunk.
``both`` runs the two directions.

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

# the forward kernel's forms (seq_fwd_split for f32 R, seq_fwd, the chain
# form, for bf16 R at small N, and seq_fwd_wide for bf16 R at large N), each
# stamped at the same anchors
FWD_FORMS = 3
# (anchor in rnn_seq.cu, text inserted before it)
_STAMPS = [
    ("  // -- the block's R slice, once",
     "  if (threadIdx.x == 0) g_start[blockIdx.x * 2] = clock64();\n"),
    ("  // -- the steps\n",
     "  if (threadIdx.x == 0) g_start[blockIdx.x * 2 + 1] = clock64();\n"),
    ("    const float* hin = t == 0 ? p.h0", "    STAMP(t, 0);\n"),
    ("      for (int k0 = 0; k0 < p.kr; k0 += KT) {\n",
     "      STAMP(t, 1);\n      long long _stg = 0, _s0 = 0;\n"),
    ("        __syncthreads();  // the previous chunk is consumed\n",
     "        _s0 = clock64();\n"),
    ("        if (k0 + KT < p.kr) prefetch_h", "        _stg += clock64() - _s0;\n"),
    ("      // -- the gate epilogue", "      STAMP(t, 2);\n"
     "      if (threadIdx.x == 0 && t < 64) g_prof[(blockIdx.x * 64 + t) * 8 + 5] = _stg;\n"),
    ("    if (!last) grid_barrier(p.bar", "    STAMP(t, 3);\n"),
]
_AFTER_BARRIER = "    if (!last) grid_barrier(p.bar, (unsigned)(t + 1) * gridDim.x);\n"
_FWD_PHASES = [("pre", 0, 1), ("product", 1, 2), ("staging", 5, None),
               ("epi", 2, 3), ("barrier", 3, 4)]
# The backward kernel's stamps, indexed by its step s (t = T-1-s): (anchor,
# text inserted before it), the barrier's line after which slot 1 goes, and
# the phases printed, (name, slot a, slot b) for the time from stamp a to
# stamp b, or (name, slot, None) for a time summed in one slot.
_BWD_STAMPS = [
    ("  // -- R^T's rows g*K + j0 + u of the block's positions",
     "  if (threadIdx.x == 0) g_start[blockIdx.x * 2] = clock64();\n"),
    ("  // The epilogue's operands of one (step t, pass) unit",
     "  if (threadIdx.x == 0) g_start[blockIdx.x * 2 + 1] = clock64();\n"),
    ("      // every block, with rows or not", "      BSTAMP(s, 0);\n"),
    ("        if (t < 0) {  // the last product: dh0", "        PSTAMP(s, 2);\n"),
    ("        // -- the block's partial of dh_{t-1}",
     "        PSTAMP(s, 3);\n        long long _sto = 0, _c0 = 0;\n"),
    ("#pragma unroll\n          for (int a = 0; a < TR; ++a) {\n"
     "            const int n = n0 + tr * TR + a;\n",
     "          _c0 = clock64();\n"),
    ("        }\n        __syncthreads();  // the dz tile is consumed",
     "          _sto += clock64() - _c0;\n"),
    ("        __syncthreads();  // the dz tile is consumed",
     "        PSTAMP(s, 5);\n"
     "        if (ch == 0 && ps == 0 && threadIdx.x == 0 && s < 64)\n"
     "          g_prof[(blockIdx.x * 64 + s) * 8 + 6] = _sto;\n"),
]
_BWD_BARRIER = ("      if (s > 0 || ch > 0) grid_barrier(p.bar, ++barriers * "
                "gridDim.x);\n")
_BWD_PHASES = [("barrier", 0, 1), ("reduction", 1, 2), ("epi", 2, 3),
               ("product", 3, 5), ("store", 6, None)]
# appended to a source from before the row-chunked backward (which sized
# its scratch in Python): that design's dbp [ceil(N/32), G*K] and exchange
# [2, N, round_up(G*K, 4)] in R's dtype, here counted in f32
_SCRATCH_SHIM = """
extern "C" int xsmm_rnn_seq_bwd_scratch(int n, int k, int gates, int, long long* f, int,
                                        void*) {
  f[0] = (n + 31) / 32 * (long long)gates * k;
  f[1] = 2LL * n * ((gates * k + 3) / 4 * 4);
  return 0;
}
"""
# appended to a source from before the forward's forms, which the wrapper
# loads: a form query that reports zeros, and forward entry points that
# take the form's pointer (the copy's own, renamed, are called from them)
# and set it to 2: the wide form, which keeps that design's geometry
_FORM_SHIM = """
extern "C" int xsmm_rnn_seq_form(int, int, int, int, int* out, int) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  return 0;
}
extern "C" int xsmm_lstm_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                             const float* c0, float* hs, float* ht, float* ct, float* cs,
                             float* is, float* gs, float* fs, float* os, float* hbuf,
                             unsigned* bar, int t, int n, int k, int* form, int device,
                             void* stream) {
  *form = 2;
  return xsmm_lstm_seq_v0(zx, r, r_bf16, h0, c0, hs, ht, ct, cs, is, gs, fs, os, hbuf, bar,
                          t, n, k, device, stream);
}
extern "C" int xsmm_gru_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                            float* hs, float* ht, float* ris, float* zis, float* gis,
                            float* zrgs, float* hbuf, unsigned* bar, int t, int n, int k,
                            int* form, int device, void* stream) {
  *form = 2;
  return xsmm_gru_seq_v0(zx, r, r_bf16, h0, hs, ht, ris, zis, gis, zrgs, hbuf, bar, t, n, k,
                         device, stream);
}
extern "C" int xsmm_rnn_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                            float* hs, float* ht, int act, float* hbuf, unsigned* bar, int t,
                            int n, int k, int* form, int device, void* stream) {
  *form = 2;
  return xsmm_rnn_seq_v0(zx, r, r_bf16, h0, hs, ht, act, hbuf, bar, t, n, k, device, stream);
}
"""
_FWD_ENTRIES = ("xsmm_lstm_seq", "xsmm_gru_seq", "xsmm_rnn_seq")
_HEAD = """namespace {
__device__ long long g_prof[%d];
__device__ long long g_start[1024];
#define STAMP(t, i) if (threadIdx.x == 0 && (t) < 64) \\
  g_prof[(blockIdx.x * 64 + (t)) * 8 + (i)] = clock64();
#define BSTAMP(s, i) if (ch == 0) STAMP(s, i)  // the backward's first row chunk
#define PSTAMP(s, i) if (ch == 0 && ps == 0) STAMP(s, i)  // and its first pass
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
    (raises ValueError if an anchor is gone from the source).  The forward's
    anchors stand once in each of its FWD_FORMS kernels, the backward's
    once."""
    expect = ([(a, FWD_FORMS) for a, _ in _STAMPS]
              + [(a, 1) for a, _ in _BWD_STAMPS] + [("namespace {\n", 1)])
    for anchor, count in expect:
        if src.count(anchor) != count:
            raise ValueError(f"anchor not found {count} time(s) in rnn_seq.cu: "
                             f"{anchor!r}")
    src = src.replace("namespace {\n", _HEAD, 1)
    for anchor, text in _STAMPS + _BWD_STAMPS:
        src = src.replace(anchor, text + anchor)
    for line, stamp, count in ((_AFTER_BARRIER, "    STAMP(t, 4);\n", FWD_FORMS),
                               (_BWD_BARRIER, "      BSTAMP(s, 1);\n", 1)):
        if src.count(line) != count:
            raise ValueError("a grid barrier's call is gone from rnn_seq.cu")
        src = src.replace(line, line + stamp)
    return src + _TAIL


def parse_variant(text: str) -> Dict[str, int]:
    if text == "base":
        return {}
    return {k.strip(): int(v) for k, v in
            (item.split("=") for item in text.split(","))}


def sources(variant: str) -> Dict[str, str]:
    """"plain" and "prof" -> the two sources of ``variant`` ("prof" left out
    for a ``src=`` copy whose anchors differ)."""
    if not variant.startswith("src="):
        src = apply_settings(SOURCE.read_text(), parse_variant(variant))
        return {"plain": src, "prof": instrument(src)}
    src = Path(variant[4:]).read_text()
    if 'extern "C" int xsmm_rnn_seq_bwd_scratch(' not in src:
        src += _SCRATCH_SHIM
    if 'extern "C" int xsmm_rnn_seq_form(' not in src:
        for name in _FWD_ENTRIES:
            src = src.replace(f'extern "C" int {name}(',
                              f'extern "C" int {name}_v0(')
        src += _FORM_SHIM
    try:
        return {"plain": src, "prof": instrument(src)}
    except ValueError:
        return {"plain": src}


def build(variants: List[str]) -> Dict[tuple, ctypes.CDLL]:
    """(variant, "plain" | "prof") -> loaded library; one nvcc each, all
    started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        for kind, text in sources(v).items():
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
    ap.add_argument("--shape", action="append", default=None,
                    help="N,C,K,T (repeat for more shapes, one build)")
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--direction", choices=("fwd", "bwd", "both"),
                    default="fwd")
    args = ap.parse_args()
    variants = args.variant or ["base"]
    if not torch.cuda.is_available():
        raise RuntimeError("seq_profile needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    clock_ghz = torch.cuda.get_device_properties(0).clock_rate / 1e6 \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") else 1.98
    libs = build(variants)

    def use(lib):
        cuda_build._LIBS["rnn_seq"] = lib
        rs._LIB = None
        rs._fits.cache_clear()
        rs._form.cache_clear()
        rs._bwd_scratch_floats.cache_clear()
        rs._lib()

    for shape in args.shape or ["128,512,512,32"]:
        n, _, k, t = (int(v) for v in shape.split(","))
        g = torch.Generator(device=dev).manual_seed(args.seed)

        def randn(*dims):
            return torch.randn(dims, generator=g, device=dev)

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
            """Random residuals in their ranges, R^T scaled to keep dh
            bounded, dz in R's dtype (as the cell emits it)."""
            dhs = randn(t, n, k)
            if gates == 4:
                res = [torch.sigmoid(randn(t, n, k)),
                       torch.tanh(randn(t, n, k)),
                       torch.sigmoid(randn(t, n, k)),
                       torch.sigmoid(randn(t, n, k)), randn(t, n, k)]
            elif gates == 3:
                res = [torch.sigmoid(randn(t, n, k)),
                       torch.sigmoid(randn(t, n, k)),
                       torch.tanh(randn(t, n, k)),
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
        dirs = (("fwd", "bwd") if args.direction == "both"
                else (args.direction,))
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
                        pairs = list(zip(got, want))
                        checks[v] = (max((torch.linalg.vector_norm(
                            (a - b).double()) / torch.linalg.vector_norm(
                                b.double())).item() for a, b in pairs),
                            all(torch.equal(a, b) for a, b in pairs))
                        ms[v].append(cuda_time_ms(run, warmup=3, iters=20))
                    dt = str(rdt).removeprefix("torch.")
                    print(f"{direction} {cell} {dt} "
                          f"(turns {' '.join(variants + variants[::-1])})")
                    for v in variants:
                        err, exact = checks[v]
                        head = (f"  {v:18s} "
                                f"{' / '.join('%.4f' % m for m in ms[v])} ms "
                                f"({min(ms[v]) * 1e3 / t:.2f} us/step); "
                                f"vs plain "
                                f"{err:.2e}{' bit-exact' if exact else ''}")
                        lib = libs.get((v, "prof"))
                        if lib is None:
                            print(head + "; no stamps (its anchors differ)")
                            continue
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
                        table = (_FWD_PHASES if direction == "fwd" else
                                 _BWD_PHASES)
                        # the last step has no barrier
                        phases = {
                            name: (p[:, :, a] if b is None else
                                   (p[:, :-1, b] - p[:, :-1, a]) if b == 4
                                   else p[:, :, b] - p[:, :, a])
                            for name, a, b in table}
                        r_us = ((start[1::2] - start[0::2])[:grid]
                                / (clock_ghz * 1e3)).mean()
                        print(head + f"; grid {grid}; R slice {r_us:.1f} us; "
                              + ", ".join(
                                  f"{name} {v_.mean():.2f}" for name, v_ in
                                  phases.items() if v_.size) + " us a step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
