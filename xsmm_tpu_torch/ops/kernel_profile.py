"""Where the time of the tiled GEMM (kernel 4), the packed loop TRSM
(kernel 14), the packed loop GETRF (kernel 12), the batched SMM (kernels
1-3), the copy (kernel 9) and the fixed-sparsity kernels (5-8) goes, on
the card.

    python -m xsmm_tpu_torch.ops.kernel_profile
        [--kernel gemm|trsm|both|getrf|smm|copy|spgemm] [--variant base]
        [--variant WG_BN_WIDE=128] [--variant src=PATH] [--size 4096]
        [--trsm 125,125,4096] [--route chunk|narrow] [--sweep]
        [--getrf 125,125,4096]
        [--smm 23,23,23,131072] [--copy 8192] [--sparse-n 65536]
        [--sparse-big 1048576] [--turns 1] [--quick]

For every variant (``base`` is the source as it is; any other is a
comma-separated list of ``NAME=VALUE`` that rewrites the source's
``constexpr int NAME = ...;``) this builds two copies of
``ops/csrc/tiled_gemm.cu`` (``--kernel gemm``), ``ops/csrc/packed.cu``
(``--kernel trsm`` or ``getrf``) or ``ops/csrc/smm_packed.cu`` (``--kernel
smm``) into ``xsmm_tpu_torch/build/kernel_profile/``: one as it is, and one
with ``clock64()`` stamps, taken by one thread of every block and summed
over the block's loop (``both`` is gemm and trsm).  It prints how many
``HGMMA`` (wgmma), ``HMMA`` (mma.sync) and ``FFMA`` instructions
``cuobjdump -sass`` finds in each build, where the toolkit has
``cuobjdump``.  Then, for each variant:

* gemm: holds every route (``tma`` and ``mma`` in bf16 and f16, ``simt``
  in f32) against ``gemm_plain`` on ragged and split-K shapes (1e-5
  rel-Frobenius with an f32 output, 1e-2 with a 16-bit one); times
  ``--size``^3 bf16 on the ``tma`` and ``mma`` routes and f32 on ``simt``,
  and the DeepBench shapes of ``samples/xgemm_driver.py`` in bf16, the
  variants in turns (a, b, ..., b, a), beside ``torch.matmul`` (TF32 off);
  prints the phases of the f32 kernel's k loop (``fetch``: the next
  tile's global loads put in flight; ``ffma``: the products; ``store``:
  the next tile into shared memory and the block barrier) and of the wgmma
  consumers' (``full``:
  waiting for TMA's stage; ``mma``: issuing the stage's wgmma; ``retire``:
  waiting for the previous stage's products), cycles a block, mean over
  blocks;
* trsm: builds ``ops/csrc/packed.cu`` per variant, where ``src=PATH`` is
  another copy of it (e.g. the parent tree's; a copy whose trsm entries
  take no route runs its one route in every case); holds ``trsm_loop`` and
  ``trsm_unrolled``, lower and upper, unit diagonal and not, on each
  ``--route`` (default both: "chunk" and "narrow") bit for bit against
  their plain versions at ``--trsm`` SM/SN/B; times the packed LU cell's
  two solves (lower unit, upper) and the lower one dividing on each route
  at ``--trsm``, the variants in turns, beside
  ``torch.linalg.solve_triangular`` on the same problems in [B, SM, SN];
  prints the phases of a chunk-route block (``load``; ``solve``, the
  solve's work seen by warp 0; ``store``; ``barrier``, warp 0's waits at
  the solve's barriers); with ``--sweep`` times the two solves at every
  ``--sweep-sm`` x ``--sweep-sn`` x ``--sweep-bp`` on the chunk route and
  on each variant's narrow route (the sweep behind
  ``packed_kernels.trsm_route``);
* getrf: holds ``getrf_loop`` on each route (``tile`` and ``shared``) bit
  for bit against ``getrf_loop_plain`` at ``--getrf`` and at every size the
  card tests take above 64 (Bp 1000); times both routes at ``--getrf`` in
  turns beside ``torch.linalg.lu_factor_ex(pivot=False)`` on the same
  problems in [B, M, N]; prints the phases of the tile route's block
  (``load``: the cluster's load; ``steps``: the tile, C_0 and the pivot
  steps' work seen by warp 0; ``store``; ``barrier``: warp 0's waits at the
  step barrier);
* smm: holds the three schedules (``packed_split2``, ``packed_split2_fast``,
  ``packed_f32`` in f32 and bf16) bit for bit against their plain versions
  at the card tests' shapes, beta 0 and 1; times them at ``--smm`` in
  turns (and ``packed_f32`` bf16 -> f32, bf16 -> bf16 and f32 -> bf16)
  beside ``torch.bmm`` (f64 for the split schedules, f32 with TF32 off);
  prints the phases of the tile kernel's persistent block (``wait``: for
  the stage, with cp.async staging the barrier and the next stage's copies
  too; ``arith``; ``store``; ``release``: with TMA staging the barrier
  after a chunk and the refill of its slot);
* copy: builds ``ops/csrc/xcopy.cu`` once per variant (no stamps), holds
  one misaligned byte copy bit for bit (source offset 3, destination 12,
  2^20 + 3 bytes; the card test ``test_copy_every_byte_offset`` holds every
  offset and count), and times it at ``--copy``^2 f32 and 16 x ``--copy``/8
  x ``--copy``/2 f32 in turns beside ``torch.clone``, with each time's
  share of the byte bound.

* spgemm: builds ``ops/csrc/spgemm.cu`` per variant, where ``src=PATH``
  is another copy of it with the same entry points (e.g. the parent
  tree's, with a shim of its own outside the package), with stamps in
  consumer warp 0 (``wait``: the prologue and the stage waits; ``sum``;
  ``store``; ``release``) where its anchors match.  On the three PyFR-
  shaped operators (``samples/pyfr_driver.py:23-30``) it holds the ten
  kernel/schedule variants bit for bit at ``--sparse-n`` and ``--sparse-n``
  + 37, and every route that fits (the kernel's ``fits``) on the 150x150
  operator, each launch counted on its route; then times the six variants
  ``chip_smoke.py`` times at ``--sparse-n`` and ``--sparse-big``, at both
  + 37 (the cp.async ring) and, on the 150x150 operator, forced on
  cp_async/shared, unstaged/shared and tma/global, the source variants in
  turns, and for each: the wrapper loop
  (CUDA events, as ``chip_smoke.py``), the kernel's device time
  (``torch.profiler``, or a CUDA graph of 20 launches where it shows
  none), a bare launch through ctypes on preallocated outputs, a cold
  launch (64 MB written before it, events around it), the host time a
  call of the wrapper and of the bare launch, the bound, the route and
  ``torch.sparse.mm`` / ``torch.addmm`` on a CSR tensor; the line through
  the two N's of each (a fixed cost a call and a stream rate); the host
  time of each step of the wrapper; and the phases of each case on its
  own route, with the largest and smallest block's total against the
  mean.

``--quick`` checks and stops before the timings.  It needs a CUDA card and
nvcc, and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import cuda_build
from ..core.platform import H100, PEAKS
from ..dnn.seq_profile import apply_settings, parse_variant

CSRC = Path(cuda_build.__file__).resolve().parent / "csrc"
OUT_DIR = cuda_build.BUILD_DIR / "kernel_profile"
PROF_BLOCKS = 8192   # blocks whose phases are kept
CLOCK_GHZ = 1.98     # the H100 SXM's boost clock, for cycles -> us

_HEAD = """namespace {
__device__ long long g_prof[%d * 4];
#define PROF_BEGIN long long _p0 = clock64(), _pacc[4] = {0, 0, 0, 0};
#define PROF_MARK(i) { const long long _t = clock64(); _pacc[i] += _t - _p0; \\
                       _p0 = _t; }
#define PROF_END(tid) { const long long _b = blockIdx.x + (long long)gridDim.x \\
    * (blockIdx.y + (long long)gridDim.y * blockIdx.z); \\
  if (threadIdx.x == (tid) && _b < %d) \\
    for (int _i = 0; _i < 4; ++_i) g_prof[_b * 4 + _i] = _pacc[_i]; }
""" % (PROF_BLOCKS, PROF_BLOCKS)
_TAIL = """
extern "C" int xsmm_prof_read(long long* prof) {
  return (int)cudaMemcpyFromSymbol(prof, g_prof, sizeof(g_prof));
}
extern "C" int xsmm_prof_zero(const long long* zeros) {
  return (int)cudaMemcpyToSymbol(g_prof, zeros, sizeof(g_prof));
}
"""

# (first line of the kernel's text, its last line, [(anchor, new text)]):
# each anchor is replaced once inside the kernel's text
_GEMM_STAMPS = [
    ("gemm_f32_kernel(const float* __restrict__ A", "// bf16/f16 in: mma.sync",
     [("  for (int kt = 0; kt < ktiles; ++kt) {\n",
       "  PROF_BEGIN\n  for (int kt = 0; kt < ktiles; ++kt) {\n"),
      ("               K, kend, aligned);\n",
       "               K, kend, aligned);\n    PROF_MARK(0)\n"),
      ("    if (more) wt_store(",
       "    PROF_MARK(1)\n    if (more) wt_store("),
      ("    __syncthreads();  // tile kt + 1 is in; every thread is done with kt\n"
       "  }\n",
       "    __syncthreads();  // tile kt + 1 is in; every thread is done with kt\n"
       "    PROF_MARK(2)\n  }\n  PROF_END(0)\n")]),
    ("gemm_wgmma_kernel(const __grid_constant__", "// C = sum over z of W[z]",
     [("    for (int kt = 0; kt < ktiles; ++kt) {\n      const int s = kt % S;\n"
       "      mbar_wait(&full[s], (kt / S) & 1);\n",
       "    PROF_BEGIN\n"
       "    for (int kt = 0; kt < ktiles; ++kt) {\n      const int s = kt % S;\n"
       "      mbar_wait(&full[s], (kt / S) & 1);\n      PROF_MARK(0)\n"),
      ("      asm volatile(\"wgmma.commit_group.sync.aligned;\\n\" ::: "
       "\"memory\");\n",
       "      asm volatile(\"wgmma.commit_group.sync.aligned;\\n\" ::: "
       "\"memory\");\n      PROF_MARK(1)\n"),
      ("        mbar_arrive(&empty[(kt - 1) % S]);\n      }\n",
       "        mbar_arrive(&empty[(kt - 1) % S]);\n      }\n"
       "      PROF_MARK(2)\n"),
      ("    asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: "
       "\"memory\");\n",
       "    asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: "
       "\"memory\");\n    PROF_END(128)\n")]),
]
_TRSM_STAMPS = [
    ("void trsm_shared_solve(", "int bucket(int size)",
     [("  // -- the load:", "  PROF_BEGIN\n  // -- the load:"),
      ("  float v[TRSM_Q][TRSM_CPL];\n",
       "  PROF_MARK(0)\n  float v[TRSM_Q][TRSM_CPL];\n"),
      ("      __syncthreads();  // x[i] is in row i of xs\n",
       "      PROF_MARK(1)\n      __syncthreads();  // x[i] is in row i of xs\n"
       "      PROF_MARK(3)\n"),
      ("  // -- the store:", "  PROF_MARK(1)\n  // -- the store:"),
      ("  cluster.sync();  // no block leaves while another reads its X\n",
       "  cluster.sync();  // no block leaves while another reads its X\n"
       "  PROF_MARK(2)\n  PROF_END(0)\n")]),
]


_GETRF_STAMPS = [
    ("getrf_tile(const float* __restrict__ a",
     "// The \"narrow\" route of kernels 13 and 14",
     [("  // -- the load: the cluster's problems",
       "  PROF_BEGIN\n  // -- the load: the cluster's problems"),
      ("  // -- the factorization", "  PROF_MARK(0)\n  // -- the factorization"),
      ("      __syncthreads();  // R_k, C_k and column k + 1 ahead are in\n",
       "      PROF_MARK(1)\n"
       "      __syncthreads();  // R_k, C_k and column k + 1 ahead are in\n"
       "      PROF_MARK(3)\n"),
      ("  cluster.sync();  // every LU is final in its block\n",
       "  PROF_MARK(1)\n  cluster.sync();  // every LU is final in its block\n"),
      ("  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n}",
       "  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n"
       "  PROF_MARK(2)\n  PROF_END(0)\n}")]),
]
_SMM_STAMPS = [
    ("packed_tile_kernel(const __grid_constant__ TileMaps maps",
     "bool plane_map(",
     [("  float acc0[TR][TC], acc1[TR][TC];\n",
       "  PROF_BEGIN\n  float acc0[TR][TC], acc1[TR][TC];\n"),
      ("    // -- the arithmetic\n", "    PROF_MARK(0)\n    // -- the arithmetic\n"),
      ("    // -- the store, after the item's last chunk\n",
       "    PROF_MARK(1)\n    // -- the store, after the item's last chunk\n"),
      ("    // -- TMA: the slot back to the ring",
       "    PROF_MARK(2)\n    // -- TMA: the slot back to the ring"),
      ("    }\n  }\n}\n\n", "    }\n    PROF_MARK(3)\n  }\n  PROF_END(0)\n}\n\n")]),
]


# the fixed-sparsity kernels (kernels 5-8): the persistent ring kernel's
# consumer warp 0, a block's tiles summed ("wait": the prologue and the
# stage waits; "sum"; "store"; "release": the slot handed back)
_SPGEMM_STAMPS = [
    ("spgemm_kernel(const __grid_constant__ Maps maps",
     "unsigned long long* sched_counters(",
     [("  // -- the consumers\n", "  PROF_BEGIN\n  // -- the consumers\n"),
      ("    if constexpr (STAGED) mbar_wait(&full[slot], (unsigned)(i / S) & 1);\n",
       "    if constexpr (STAGED) mbar_wait(&full[slot], (unsigned)(i / S) & 1);\n"
       "    PROF_MARK(0)\n"),
      ("    for (int r = r0 + warp; r < r1; r += RG) {\n",
       "    for (int r = r0 + warp; r < r1; r += RG) {\n      PROF_MARK(2)\n"),
      ("      // -- the store\n", "      PROF_MARK(1)\n      // -- the store\n"),
      ("    // -- the slot back to the producer\n",
       "    PROF_MARK(2)\n    // -- the slot back to the producer\n"),
      ("    if (lane == 0) mbar_arrive(&empty[slot]);\n  }\n}\n",
       "    if (lane == 0) mbar_arrive(&empty[slot]);\n    PROF_MARK(3)\n  }\n"
       "  PROF_END(0)\n}\n")]),
]


def spgemm_sources(variant: str) -> Dict[str, str]:
    """"plain" and "prof" -> the two sources of a ``--kernel spgemm``
    variant: ``base``, ``NAME=VALUE,...`` or ``src=PATH`` (a copy with this
    tree's entry points; one whose anchors differ is timed without
    stamps)."""
    if variant.startswith("src="):
        src = Path(variant[4:]).read_text()
    else:
        src = apply_settings((CSRC / "spgemm.cu").read_text(),
                             parse_variant(variant))
    try:
        return {"plain": src, "prof": instrument(src, _SPGEMM_STAMPS)}
    except ValueError:
        return {"plain": src}


def instrument(src: str, stamps) -> str:
    """``src`` with the stamps inside each kernel's text and the entry points
    that read them (raises if an anchor is gone)."""
    for first, last, edits in stamps:
        i = src.index(first)
        j = src.index(last, i)
        body = src[i:j]
        for anchor, text in edits:
            if body.count(anchor) != 1:
                raise ValueError(f"anchor not found once: {anchor!r}")
            body = body.replace(anchor, text)
        src = src[:i] + body + src[j:]
    if src.count("namespace {\n") < 1:
        raise ValueError("no anonymous namespace in the source")
    return src.replace("namespace {\n", _HEAD, 1) + _TAIL


def build(name: str, variants: List[str], stamps,
          sources: Optional[Callable] = None) -> Dict[tuple, Path]:
    """(variant, "plain" | "prof") -> built library; one nvcc each, all
    started together.  ``sources(variant)`` gives a variant's texts by kind
    where the stamps alone do not."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    base = (CSRC / f"{name}.cu").read_text()
    procs = {}
    for i, v in enumerate(variants):
        if sources is not None:
            kinds = list(sources(v).items())
        else:
            src = apply_settings(base, parse_variant(v))
            kinds = [("plain", src)] + ([("prof", instrument(src, stamps))]
                                        if stamps else [])
        for kind, text in kinds:
            cu = OUT_DIR / f"{name}_v{i}_{kind}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                   "-I", str(CSRC), "-o", str(so), str(cu)]
            procs[(v, kind)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    out = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=cuda_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {key}:\n{log}")
        if key[1] == "plain":
            print(f"build {name} {key[0]}: " + "; ".join(
                line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line.lower()
                or "warning" in line.lower() or "Compiling entry" in line))
        out[key] = so
    return out


def sass_counts(so: Path) -> Optional[Dict[str, int]]:
    """HGMMA / HMMA / FFMA instruction counts of a built library (None
    without ``cuobjdump``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    return {op: sass.count(op + ".") + sass.count(op + " ")
            for op in ("HGMMA", "HMMA", "FFMA")}


def _phases(lib, run: Callable, names, blocks: int, spread: bool = False):
    """Run once with the stamps; mean cycles of each phase a block (with
    ``spread`` the largest block total over the mean too)."""
    import numpy as np
    import torch

    lib.xsmm_prof_zero.argtypes = [ctypes.c_void_p]
    lib.xsmm_prof_read.argtypes = [ctypes.c_void_p]
    zeros = np.zeros(PROF_BLOCKS * 4, np.int64)
    lib.xsmm_prof_zero(zeros.ctypes.data)
    run()
    torch.cuda.synchronize()
    prof = np.zeros(PROF_BLOCKS * 4, np.int64)
    lib.xsmm_prof_read(prof.ctypes.data)
    p = prof.reshape(PROF_BLOCKS, 4)[:min(blocks, PROF_BLOCKS)].astype(float)
    p = p[p.sum(axis=1) > 0]  # blocks that stamped (a grid may be smaller)
    tot = p[:, :len(names)].sum(axis=1).mean() if len(p) else 0
    if not tot:
        return "no stamps (the stamped kernel did not run)"
    totals = p[:, :len(names)].sum(axis=1)
    return ", ".join(f"{n} {p[:, i].mean():.0f} ({p[:, i].mean() / tot:.0%})"
                     for i, n in enumerate(names)) + \
        f" cycles a block ({tot / CLOCK_GHZ / 1e3:.1f} us)" + (
            f"; largest block {totals.max() / tot:.3f} of the mean, "
            f"smallest {totals.min() / tot:.3f}" if spread else "")


def main() -> int:
    import torch

    from . import packed_kernels as pk
    from . import tiled_gemm_kernels as tk
    from ..utils.timer import cuda_time_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("gemm", "trsm", "both", "getrf",
                                         "smm", "copy", "spgemm"),
                    default="both")
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--trsm", default="125,125,4096", help="SM,SN,B")
    ap.add_argument("--route", action="append", default=None,
                    choices=("chunk", "narrow"), help="the trsm routes")
    ap.add_argument("--sweep", action="store_true",
                    help="trsm: time both routes over --sweep-sm/sn/bp")
    ap.add_argument("--sweep-sm", default="64,65,96,125,128")
    ap.add_argument("--sweep-sn", default="1,2,4,8,16,32")
    ap.add_argument("--sweep-bp", default="4096,131072")
    ap.add_argument("--getrf", default="125,125,4096", help="M,N,B")
    ap.add_argument("--smm", default="23,23,23,131072", help="M,N,K,B")
    ap.add_argument("--copy", type=int, default=8192, help="T: T^2 f32 and "
                    "16 x T/8 x T/2 f32")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of turns (a, b, ..., b, a) of the timings")
    ap.add_argument("--sparse-n", type=int, default=65536)
    ap.add_argument("--sparse-big", type=int, default=1 << 20)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    variants = args.variant or ["base"]
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_profile needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    print(f"{torch.cuda.get_device_name(0)}; cycles at {CLOCK_GHZ} GHz")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def turns(cases: Dict[str, Callable], use: Callable):
        """ms[variant][case], the variants in turns a, b, ..., b, a (that
        ``--turns`` times)."""
        ms = {v: {c: [] for c in cases} for v in variants}
        for v in (variants + variants[::-1]) * args.turns:
            use(v, "plain")
            for c, fn in cases.items():
                ms[v][c].append(cuda_time_ms(fn, warmup=3, iters=20))
        return ms

    if args.kernel in ("gemm", "both"):
        libs = build("tiled_gemm", variants, _GEMM_STAMPS)

        def use(v, kind):
            cuda_build._LIBS["tiled_gemm"] = ctypes.CDLL(str(libs[(v, kind)]))
            return tk._lib()

        bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
        shapes = [(256, 256, 256), (300, 200, 136), (129, 264, 1000),
                  (1, 8, 8), (1760, 128, 1760), (2048, 64, 2048)]
        for v in variants:
            print(f"gemm {v}: sass {sass_counts(libs[(v, 'plain')])}")
            use(v, "plain")
            for m, n, k in shapes:
                for rt, dt in (("tma", bf16), ("tma", f16), ("mma", bf16),
                               ("simt", f32)):
                    a, b = randn(m, k, dtype=dt), randn(k, n, dtype=dt)
                    for out in (f32, dt):
                        got = tk.gemm(a, b, out_dtype=out, route=rt)
                        want = tk.gemm_plain(a, b, out_dtype=out, bk=512)
                        torch.cuda.synchronize()
                        err = (torch.linalg.vector_norm((got - want).double())
                               / torch.linalg.vector_norm(want.double())).item()
                        tol = 1e-5 if out == f32 else 1e-2
                        print(f"  check {rt:4s} {str(dt)[6:]:8s}->"
                              f"{str(out)[6:]:8s} {m}x{n}x{k}: {err:.2e} "
                              f"{'pass' if err <= tol else 'FAIL'}")
        if not args.quick:
            s = args.size
            a16, b16 = randn(s, s, dtype=bf16), randn(s, s, dtype=bf16)
            a32, b32 = randn(s, s), randn(s, s)
            cases = {
                f"bf16 {s}^3 tma": lambda: tk.gemm(a16, b16, out_dtype=bf16,
                                                   route="tma"),
                f"bf16 {s}^3 mma": lambda: tk.gemm(a16, b16, out_dtype=bf16,
                                                   route="mma"),
                f"f32 {s}^3 simt": lambda: tk.gemm(a32, b32, out_dtype=f32)}
            deep = [(1760, 128, 1760), (2048, 64, 2048), (2560, 64, 2560),
                    (4096, 128, 4096)]
            for m, n, k in deep:
                a, b = randn(m, k, dtype=bf16), randn(k, n, dtype=bf16)
                for rt in ("tma", "mma"):
                    cases[f"bf16 {m}x{n}x{k} {rt}"] = (
                        lambda a=a, b=b, rt=rt: tk.gemm(a, b, out_dtype=bf16,
                                                        route=rt))
                cases[f"bf16 {m}x{n}x{k} torch.matmul"] = (
                    lambda a=a, b=b: torch.matmul(a, b))
            lib_ms = {f"bf16 {s}^3": cuda_time_ms(torch.matmul, a16, b16),
                      f"f32 {s}^3": cuda_time_ms(torch.matmul, a32, b32)}
            ms = turns(cases, use)
            print(f"torch.matmul bf16 {s}^3 {lib_ms[f'bf16 {s}^3']:.4f} ms, "
                  f"f32 {lib_ms[f'f32 {s}^3']:.4f} ms")
            for v in variants:
                for c in cases:
                    m_, n_, k_ = (s, s, s) if "^3" in c else (
                        int(x) for x in c.split()[1].split("x"))
                    tf = 2 * m_ * n_ * k_ / min(ms[v][c]) / 1e9
                    print(f"  {v:24s} {c:32s} "
                          f"{' / '.join('%.4f' % t for t in ms[v][c])} ms "
                          f"({tf:.1f} TFLOP/s)")
            for v in variants:
                lib = use(v, "prof")
                blocks = (s // 128) * (s // 128)
                print(f"  {v}: f32 phases: " + _phases(
                    lib, cases[f"f32 {s}^3 simt"], ("fetch", "ffma", "store"),
                    blocks))
                print(f"  {v}: wgmma consumer phases: " + _phases(
                    lib, cases[f"bf16 {s}^3 tma"], ("full", "mma", "retire"),
                    (s // 128) * (s // 256)))

    if args.kernel in ("trsm", "both"):
        profile_trsm(args, variants, randn, turns)

    if args.kernel == "getrf":
        profile_getrf(args, variants, randn, turns)
    if args.kernel == "smm":
        profile_smm(args, variants, randn, turns)
    if args.kernel == "copy":
        profile_copy(args, variants, randn, turns)
    if args.kernel == "spgemm":
        profile_spgemm(args, variants, randn, turns)
    return 0


def _bits(label: str, got, want) -> None:
    """Print and raise unless ``got`` equals ``want`` bit for bit."""
    import torch

    torch.cuda.synchronize()
    ok = torch.equal(got, want) and bool(torch.isfinite(got).all())
    print(f"  check {label}: {'bit-exact' if ok else 'FAIL'} (max "
          f"{(got.double() - want.double()).abs().max().item():.2e})")
    if not ok:
        raise RuntimeError(f"{label}: kernel and plain version disagree")


def packed_sources(variant: str) -> Dict[str, str]:
    """"plain" and "prof" -> the two sources of a ``--kernel trsm``
    variant: ``base``, ``NAME=VALUE,...`` or ``src=PATH`` (another copy of
    ``packed.cu``, e.g. the parent tree's; one without the trsm entries'
    ``route`` runs its one route, whatever route a case names)."""
    if variant.startswith("src="):
        src = Path(variant[4:]).read_text()
    else:
        src = apply_settings((CSRC / "packed.cu").read_text(),
                             parse_variant(variant))
    return {"plain": src, "prof": instrument(src, _TRSM_STAMPS)}


def _routed(src: str) -> bool:
    """Whether the trsm entry points of a ``packed.cu`` take a route."""
    i = src.index("int xsmm_trsm_loop(")
    return "route" in src[i:src.index("{", i)]


def _trsm_launcher(so: Path, routed: bool) -> Callable:
    """``solve(kernel, a, b, unit, upper, route)`` -> X through the entry
    points of the library ``so`` (as ``packed_kernels._trsm``, without its
    counts); ``routed``: its entries take the route."""
    import torch

    from . import packed_kernels as pk

    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("trsm_loop", "trsm_unrolled"):
        for suffix in ("", "_upper"):
            fn = getattr(lib, f"xsmm_{name}{suffix}")
            fn.argtypes = [p, p, p, i, i, ll, i] + [i] * routed + [i, p]
            fn.restype = ctypes.c_int

    def solve(kernel, a, b, unit, upper, route):
        sm, sn, bp = b.shape
        x = torch.empty_like(b)
        extra = [pk.TRSM_ROUTES[route or pk.trsm_route(sm, sn, bp)]] * routed
        cuda_build.launch(getattr(lib, f"xsmm_{kernel}{'_upper' * upper}"),
                          a.device, a.data_ptr(), b.data_ptr(), x.data_ptr(),
                          sm, sn, bp, int(unit), *extra)
        return x
    return solve


def profile_trsm(args, variants, randn, turns) -> None:
    """The --kernel trsm part of the module docstring."""
    import torch

    from . import packed_kernels as pk
    from ..utils.timer import cuda_time_ms

    routes = args.route or list(pk.TRSM_ROUTES)
    srcs = {v: packed_sources(v)["plain"] for v in variants}
    libs = build("packed", variants, None, lambda v: {
        k: t for k, t in packed_sources(v).items()
        if k == "plain" or "chunk" in routes})
    routed = {v: _routed(srcs[v]) for v in variants}
    cur: Dict[str, Callable] = {}

    def use(v, kind):
        cur["solve"] = _trsm_launcher(libs[(v, kind)], routed[v])

    def solve(*args_):
        return cur["solve"](*args_)

    def problems(sm, sn, bsz):
        """A [SM, SM, B] (entries of size 1/SM off the diagonal, 1 + ... on
        it: either triangle, unit or not) and B [SM, SN, B], packed."""
        a = randn(sm, sm, bsz) / sm
        idx = torch.arange(sm, device=a.device)
        a[idx, idx] += 1.0
        return a, randn(sm, sn, bsz)

    sm, sn, bsz = (int(x) for x in args.trsm.split(","))
    pa, pb = problems(sm, sn, bsz)
    for v in variants:
        use(v, "plain")
        for rt in routes if routed[v] else ["its own"]:
            for kname in ("trsm_loop", "trsm_unrolled"):
                for unit in (False, True):
                    for upper in (False, True):
                        plain = getattr(pk, kname + "_upper" * upper
                                        + "_plain")
                        _bits(f"{v} {rt} {kname} {'upper' if upper else 'lower'}"
                              f" unit={unit} {sm}/{sn} B={bsz}",
                              solve(kname, pa, pb, unit, upper,
                                    None if rt == "its own" else rt),
                              plain(pa, pb, unit))
    if args.quick:
        return
    # the packed LU cell's two solves (lower unit, upper), and the lower
    # one dividing, on each route (a variant without routes: its own)
    cases = {}
    for rt in routes:
        for label, unit, upper in (("lower unit", True, False),
                                   ("upper", False, True),
                                   ("lower", False, False)):
            cases[f"trsm_loop {label} {rt} {sm}/{sn} B={bsz}"] = (
                lambda unit=unit, upper=upper, rt=rt:
                solve("trsm_loop", pa, pb, unit, upper, rt))
    lib_ms = cuda_time_ms(lambda: torch.linalg.solve_triangular(
        pa.permute(2, 0, 1), pb.permute(2, 0, 1), upper=False))
    ms = turns(cases, use)
    print(f"solve_triangular {sm}/{sn} B={bsz}: {lib_ms:.4f} ms "
          f"(on [B, SM, SM] views of the packed operands)")
    for v in variants:
        for c in cases:
            print(f"  {v:24s} {c:44s} "
                  f"{' / '.join('%.4f' % t for t in ms[v][c])} ms"
                  + ("" if routed[v] else " (its one route)"))
    if "chunk" in routes:
        for v in variants:
            use(v, "prof")
            print(f"  {v}: trsm chunk phases: " + _phases(
                ctypes.CDLL(str(libs[(v, "prof")])),
                lambda: solve("trsm_loop", pa, pb, False, False, "chunk"),
                ("load", "solve", "store", "barrier"),
                bsz * ((sn + 127) // 128)))
    if args.sweep:
        del pa, pb
        sweep_trsm(args, variants, use, solve, problems)


def sweep_trsm(args, variants, use, solve, problems) -> None:
    """The cell's two solves (lower unit, upper) at every (SM, SN, B) of the
    sweep: ms a launch on the chunk route (the first variant) and on the
    narrow route of each variant, and the fastest."""
    from ..utils.timer import cuda_time_ms

    print("sweep: SM SN B solve: chunk ms, narrow ms of "
          f"{', '.join(variants)}; fastest")
    for bsz in (int(x) for x in args.sweep_bp.split(",")):
        for sm in (int(x) for x in args.sweep_sm.split(",")):
            a, b = problems(sm, max(int(x) for x in args.sweep_sn.split(",")),
                            bsz)
            for sn in (int(x) for x in args.sweep_sn.split(",")):
                bs = b[:, :sn].contiguous()
                for label, unit, upper in (("lower unit", True, False),
                                           ("upper", False, True)):
                    t = {}
                    for v, rt in [(variants[0], "chunk")] + [
                            (v, "narrow") for v in variants]:
                        use(v, "plain")
                        t[f"{rt} {v}"] = cuda_time_ms(
                            lambda rt=rt: solve("trsm_loop", a, bs, unit,
                                                upper, rt), warmup=2, iters=5)
                    print(f"  sweep {sm} {sn} {bsz} {label}: "
                          + ", ".join(f"{x:.4f}" for x in t.values())
                          + f"; {min(t, key=t.get)}")
                del bs
            del a, b


def profile_getrf(args, variants, randn, turns) -> None:
    """The --kernel getrf part of the module docstring."""
    import torch

    from . import packed_kernels as pk

    libs = build("packed", variants, _GETRF_STAMPS)

    def use(v, kind):
        cuda_build._LIBS["packed"] = ctypes.CDLL(str(libs[(v, kind)]))
        return pk._lib()

    def lower(bsz, m, n):
        a = randn(bsz, m, n) / m
        idx = torch.arange(min(m, n), device=a.device)
        a[:, idx, idx] += 1.0
        return a

    m, n, bsz = (int(x) for x in args.getrf.split(","))
    a = lower(bsz, m, n)
    pa = a.permute(1, 2, 0).contiguous()
    small = {s: lower(1000, *s).permute(1, 2, 0).contiguous()
             for s in ((65, 65), (70, 20), (80, 80), (100, 70), (70, 100),
                       (128, 128), (140, 140))}
    for v in variants:
        use(v, "plain")
        for x in [pa, *small.values()]:
            for rt in ("tile", "shared"):
                if rt == "tile" and pk.getrf_route(*x.shape[:2]) != "tile":
                    continue
                _bits(f"{v} getrf_loop {rt} {x.shape[0]}x{x.shape[1]} "
                      f"Bp={x.shape[2]}", pk._getrf_loop(x, rt),
                      pk.getrf_loop_plain(x))
    if args.quick:
        return
    cases = {f"getrf_loop tile {m}x{n} B={bsz}":
             lambda: pk._getrf_loop(pa, "tile"),
             f"getrf_loop shared {m}x{n} B={bsz}":
             lambda: pk._getrf_loop(pa, "shared"),
             f"lu_factor_ex(pivot=False) {m}x{n} B={bsz}":
             lambda: torch.linalg.lu_factor_ex(a, pivot=False)}
    ms = turns(cases, use)
    for v in variants:
        for c in cases:
            print(f"  {v:24s} {c:44s} "
                  f"{' / '.join('%.4f' % t for t in ms[v][c])} ms")
    for v in variants:
        lib = use(v, "prof")
        print(f"  {v}: getrf tile phases: " + _phases(
            lib, cases[f"getrf_loop tile {m}x{n} B={bsz}"],
            ("load", "steps", "store", "barrier"), (bsz + 7) // 8 * 8))


def profile_smm(args, variants, randn, turns) -> None:
    """The --kernel smm part of the module docstring."""
    import torch

    from . import smm_packed as sp

    libs = build("smm_packed", variants, _SMM_STAMPS)

    def use(v, kind):
        cuda_build._LIBS["smm_packed"] = ctypes.CDLL(str(libs[(v, kind)]))
        return sp._lib()

    def planes(*shapes, dtype=torch.float32):
        return [randn(*s, dtype=dtype) for s in shapes]

    shapes = [(23, 23, 23, 131), (1, 1, 1, 33), (5, 3, 7, 1000),
              (13, 13, 13, 64), (16, 48, 8, 257), (64, 64, 64, 40),
              (2, 70, 3, 77), (1, 2000, 1, 50)]
    for v in variants:
        use(v, "plain")
        for m, n, k, bp in shapes:
            ah, al, bh, bl, ch, cl = planes((m, k, bp), (m, k, bp), (k, n, bp),
                                            (k, n, bp), (m, n, bp), (m, n, bp))
            for beta in (0, 1):
                cins = (ch, cl) if beta else (None, None)
                got = sp.packed_split2(ah, al, bh, bl, *cins)
                want = sp.packed_split2_plain(ah, al, bh, bl, *cins)
                for i in range(2):
                    _bits(f"{v} split2 {m}x{n}x{k} Bp={bp} beta={beta} "
                          f"c{'hl'[i]}", got[i], want[i])
                _bits(f"{v} split2_fast {m}x{n}x{k} Bp={bp} beta={beta}",
                      sp.packed_split2_fast(ah, bh, bl, cins[0]),
                      sp.packed_split2_fast_plain(ah, bh, bl, cins[0]))
                for dt in (torch.float32, torch.bfloat16):
                    x, y = ah.to(dt), bh.to(dt)
                    c = None if not beta else ch.to(dt)
                    _bits(f"{v} f32 {str(dt)[6:]} {m}x{n}x{k} Bp={bp} "
                          f"beta={beta}", sp.packed_f32(x, y, c, out_dtype=dt),
                          sp.packed_f32_plain(x, y, c, out_dtype=dt))
    m, n, k, bsz = (int(x) for x in args.smm.split(","))
    ah, al, bh, bl = planes((m, k, bsz), (m, k, bsz), (k, n, bsz),
                            (k, n, bsz))
    got = sp.packed_split2(ah, al, bh, bl)
    want = sp.packed_split2_plain(ah, al, bh, bl)
    for i in range(2):
        _bits(f"split2 {m}x{n}x{k} B={bsz} c{'hl'[i]}", got[i], want[i])
    del got, want
    if args.quick:
        return
    a64, b64 = randn(bsz, m, k, dtype=torch.float64), randn(
        bsz, k, n, dtype=torch.float64)
    a32, b32 = a64.float(), b64.float()
    a16, b16 = ah.bfloat16(), bh.bfloat16()
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {f"split2 {m}x{n}x{k} B={bsz}":
             lambda: sp.packed_split2(ah, al, bh, bl),
             f"split2_fast {m}x{n}x{k} B={bsz}":
             lambda: sp.packed_split2_fast(ah, bh, bl),
             f"f32 {m}x{n}x{k} B={bsz}":
             lambda: sp.packed_f32(ah, bh, out_dtype=f32),
             f"f32 bf16->f32 {m}x{n}x{k} B={bsz}":
             lambda: sp.packed_f32(a16, b16, out_dtype=f32),
             f"f32 bf16->bf16 {m}x{n}x{k} B={bsz}":
             lambda: sp.packed_f32(a16, b16, out_dtype=bf16),
             f"f32 f32->bf16 {m}x{n}x{k} B={bsz}":
             lambda: sp.packed_f32(ah, bh, out_dtype=bf16),
             "torch.bmm f64": lambda: torch.bmm(a64, b64),
             "torch.bmm f32": lambda: torch.bmm(a32, b32)}
    ms = turns(cases, use)
    for v in variants:
        for c in cases:
            print(f"  {v:24s} {c:36s} "
                  f"{' / '.join('%.4f' % t for t in ms[v][c])} ms")
    for v in variants:
        lib = use(v, "prof")
        print(f"  {v}: split2 tile phases: " + _phases(
            lib, cases[f"split2 {m}x{n}x{k} B={bsz}"],
            ("wait", "arith", "store", "release"), PROF_BLOCKS))


def profile_copy(args, variants, randn, turns) -> None:
    """The --kernel copy part of the module docstring."""
    import torch

    from . import xcopy_kernels as xk

    libs = build("xcopy", variants, None)

    def use(v, kind):
        cuda_build._LIBS["xcopy"] = ctypes.CDLL(str(libs[(v, kind)]))
        return xk._lib()

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(args.seed + 9)
    count, a, b = (1 << 20) + 3, 3, 12
    src = torch.randint(0, 256, (count + 16,), generator=g, device=dev,
                        dtype=torch.uint8)
    want = torch.zeros(count + 32, dtype=torch.uint8, device=dev)
    want[b:b + count] = src[a:a + count]
    for v in variants:
        dst = torch.zeros_like(want)
        cuda_build.launch(use(v, "plain").xsmm_copy, dev, src.data_ptr() + a,
                          dst.data_ptr() + b, count)
        exact = torch.equal(dst, want)
        print(f"  check {v}: {count} bytes, source offset {a}, destination "
              f"{b}: {'bit-exact' if exact else 'FAIL'}")
        if not exact:
            raise RuntimeError(f"{v}: the copy kernel is wrong")
    if args.quick:
        return
    t = args.copy
    x, xb = randn(t, t), randn(16, t // 8, t // 2)
    cases = {f"copy f32 {t}^2": lambda: xk.copy(x),
             f"clone f32 {t}^2": lambda: torch.clone(x),
             f"copy f32 16x{t // 8}x{t // 2}": lambda: xk.copy(xb),
             f"clone f32 16x{t // 8}x{t // 2}": lambda: torch.clone(xb)}
    ms = turns(cases, use)
    bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"copy bound (bytes, {HBM_BYTES_PER_S / 1e12:g} TB/s): "
          f"{bound:.4f} ms")
    for v in variants:
        for c in cases:
            print(f"  {v:32s} {c:28s} "
                  f"{' / '.join('%.4f' % m for m in ms[v][c])} ms (share "
                  f"{bound / min(ms[v][c]):.3f})")


# (M, K, density) of the PyFR-shaped operators, samples/pyfr_driver.py:23-30
PYFR_SPECS = [(105, 75, 0.11), (75, 105, 0.08), (150, 150, 0.05)]
HBM_BYTES_PER_S = PEAKS[H100]["hbm_bytes_per_s"]
# (kernel, f64 schedule) of the timed variants, as chip_smoke.py times them
SPGEMM_TIMED = [("unroll_f32", None), ("acc_f32", None),
                ("unroll_f64", "split2"), ("unroll_f64", "fold"),
                ("acc_f64", "split2"), ("acc_f64", "fold")]
SCHED_PLANES = {"split2": (True, True), "split2_fast": (True, False),
                "split2_wout": (False, True), "fold": (False, False)}


def device_ms(fn: Callable, key: str, iters: int = 20) -> Optional[float]:
    """Mean device time of the kernels whose name holds ``key`` over
    ``iters`` calls of ``fn``, from ``torch.profiler``'s ``key_averages``
    (None where the profiler shows no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if key in e.key:
            us += getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0)
            n += e.count
    return us / n / 1e3 if n and us else None


def graph_ms(fn: Callable, iters: int = 20) -> float:
    """ms a call of ``iters`` calls of ``fn`` captured in one CUDA graph
    and replayed between two events."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def cold_ms(fn: Callable, flush, iters: int = 20) -> float:
    """Median ms of one call of ``fn`` with ``flush`` (64 MB) written just
    before it, one pair of events around each call."""
    import torch

    times = []
    for i in range(iters + 2):
        flush.fill_(float(i))
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def host_us(fn: Callable, calls: int = 200) -> float:
    """Host microseconds a call of ``fn``, enqueued back to back."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def fit(n_bytes, ms):
    """(fixed us, stream TB/s) of the line through two (bytes, ms) points."""
    (b0, t0), (b1, t1) = zip(n_bytes, ms)
    rate = (b1 - b0) / ((t1 - t0) * 1e-3) if t1 != t0 else float("inf")
    return (t0 * 1e-3 - b0 / rate) * 1e6, rate / 1e12


def profile_spgemm(args, variants, randn, turns) -> None:
    """The --kernel spgemm part of the module docstring."""
    import numpy as np
    import torch

    from . import spgemm_kernels as sk
    from ..utils.mtx import Csr
    from ..utils.timer import cuda_time_ms

    libs = build("spgemm", variants, None, spgemm_sources)

    def use(v, kind):
        cuda_build._LIBS["spgemm"] = ctypes.CDLL(str(libs[(v, kind)]))
        for _, op in ops:
            op.routes.clear()  # a variant's own fit
        return sk._lib()

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ops = []
    for m, k, dens in PYFR_SPECS:
        a = np.where(rng.random((m, k)) < dens, rng.standard_normal((m, k)),
                     0.0)
        ops.append((f"{m}x{k}", sk.SparseOperator(Csr.from_dense(a), dev)))

    def planes_of(kname, sched, d):
        b_lo = SCHED_PLANES[sched][0] if sched else False
        return [d["bh"]] + ([d["bl"]] if b_lo else [])

    def call(op, kname, sched, d, bare=False, route=None):
        """A call of kernel ``kname`` on operands ``d`` (the wrapper, on
        ``route`` where given, or with ``bare`` its entry point through
        ctypes on preallocated outputs)."""
        b_lo, c_lo = SCHED_PLANES[sched] if sched else (False, False)
        bl = d["bl"] if b_lo else None
        cl = d["cl"] if c_lo else None
        kw = {} if route is None else {"route": route}
        if not bare:
            return {"unroll_f32": lambda: sk.unroll_f32(op, d["bh"], **kw),
                    "acc_f32": lambda: sk.acc_f32(op, d["ch"], d["bh"], **kw),
                    "unroll_f64": lambda: sk.unroll_f64(op, d["bh"], bl,
                                                        c_lo=c_lo, **kw),
                    "acc_f64": lambda: sk.acc_f64(op, d["ch"], cl, d["bh"],
                                                  bl, **kw)}[kname]
        lib = sk._lib()
        p = cuda_build.ptr
        f64 = kname.endswith("f64")
        st, sr = route or sk.pick_route(op, f64, planes_of(kname, sched, d),
                                        _cin_planes(kname, sched))
        o0, o1 = d["o0"], (d["o1"] if c_lo else None)
        head = [p(op.row_ptr), p(op.col_idx), p(op.vh)]
        ptrs = {"unroll_f32": head + [p(d["bh"]), p(o0)],
                "acc_f32": head + [p(d["ch"]), p(d["bh"]), p(o0)],
                "unroll_f64": head + [p(op.vl), p(d["bh"]), p(bl), p(o0),
                                      p(o1)],
                "acc_f64": head + [p(op.vl), p(d["ch"]), p(cl), p(d["bh"]),
                                   p(bl), p(o0), p(o1)]}[kname]
        fn = getattr(lib, "xsmm_spgemm_" + kname)
        full = (*ptrs, op.m, op.k, d["n"], op.nnz, sk.STAGINGS.index(st),
                sk.STRUCTURES.index(sr), 0,
                torch.cuda.current_stream(dev).cuda_stream)
        return lambda: fn(*full)

    def operands(op, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        bh, bl = (torch.randn((op.k, n), generator=g, device=dev)
                  for _ in range(2))
        ch, cl = (torch.randn((op.m, n), generator=g, device=dev)
                  for _ in range(2))
        return dict(n=n, bh=bh, bl=bl, ch=ch, cl=cl,
                    o0=torch.empty_like(ch), o1=torch.empty_like(ch))

    def nbytes(op, kname, sched, n):
        b_lo, c_lo = SCHED_PLANES[sched] if sched else (False, False)
        f64 = kname.endswith("f64")
        c = (2 if c_lo else 1) * op.m * n * 4
        return ((2 if b_lo else 1) * op.k * n * 4 + c
                + (c if kname.startswith("acc") else 0) + 4 * (op.m + 1)
                + op.nnz * (12 if f64 else 8))

    # -- checks: every timed variant bit for bit at N and N + 37 (ragged),
    # and every route that fits on the 150x150 operator at N + 37 and N
    checks = {(name, n): operands(op, n, 5) for name, op in ops
              for n in (args.sparse_n, args.sparse_n + 37)}
    for v in variants:
        use(v, "plain")
        for (name, n), d in checks.items():
            op = dict(ops)[name]
            for kname, sched in [*SPGEMM_TIMED, ("unroll_f64", "split2_fast"),
                                 ("unroll_f64", "split2_wout"),
                                 ("acc_f64", "split2_fast"),
                                 ("acc_f64", "split2_wout")]:
                _spgemm_check(sk, v, name, op, kname, sched, d, None)
        name, op = ops[2]
        for n in (args.sparse_n + 37, args.sparse_n):
            d = checks[(name, n)]
            for kname, sched in SPGEMM_TIMED:
                planes = planes_of(kname, sched, d)
                for rt in ((st, sr) for st in sk.STAGINGS
                           for sr in sk.STRUCTURES):
                    if ((rt[0] != "tma" or sk.tma_addresses(planes))
                            and sk.fits(op, kname.endswith("f64"),
                                        len(planes),
                                        _cin_planes(kname, sched), rt)):
                        _spgemm_check(sk, v, name, op, kname, sched, d, rt)
        print(f"  {v}: route launches {dict(sk.route_launches)}")
    del checks
    torch.cuda.empty_cache()
    if args.quick:
        return

    # -- times: every operator at N and the big N, and at both + 37 (the
    # cp.async ring); the 150x150 operator on each other route; the
    # variants in turns
    widths = [("", args.sparse_n, args.sparse_big),
              ("odd ", args.sparse_n + 37, args.sparse_big + 37)]
    forced = [None, ("cp_async", "shared"), ("unstaged", "shared"),
              ("tma", "global")]
    big, cases, meta = {}, {}, {}
    for name, op in ops:
        for tag, n_small, n_big in widths:
            for n in (n_small, n_big):
                for kname, sched in SPGEMM_TIMED:
                    for rt in (forced if name == ops[2][0] and not tag
                               else [None]):
                        c = (f"{name} N={n} {kname} {sched or 'f32'}"
                             + (f" {rt[0]}/{rt[1]}" if rt else ""))
                        if (name, n) not in big:
                            big[(name, n)] = operands(op, n, 6)
                        d = big[(name, n)]
                        cases[c] = call(op, kname, sched, d, route=rt)
                        meta[c] = (op, kname, sched, d, name, n, rt,
                                   (tag, n_small, n_big))
    ms = turns(cases, use)
    lib_ms = {}
    for (name, n), d in big.items():
        op = dict(ops)[name]
        a = torch.zeros((op.m, op.k), device=dev, dtype=torch.float64)
        rows = torch.repeat_interleave(torch.arange(op.m, device=dev),
                                       op.row_ptr.diff().long())
        a[rows, op.col_idx.long()] = op.vh.double() + op.vl.double()
        csr32, csr64 = a.float().to_sparse_csr(), a.to_sparse_csr()
        b64, c64 = d["bh"].double(), d["ch"].double()
        lib_ms[(name, n)] = {
            "sparse.mm f32": cuda_time_ms(torch.sparse.mm, csr32, d["bh"]),
            "addmm f32": cuda_time_ms(torch.addmm, d["ch"], csr32, d["bh"]),
            "sparse.mm f64": cuda_time_ms(torch.sparse.mm, csr64, b64),
            "addmm f64": cuda_time_ms(torch.addmm, c64, csr64, b64)}
        del b64, c64
    smi = _smi()
    _spgemm_host_parts(sk, ops[2][1], operands(ops[2][1], args.sparse_n, 7))
    print(f"spgemm times, ms (turns; bound at {HBM_BYTES_PER_S / 1e12} TB/s)"
          f"  [{smi}]")
    flush = torch.empty(16 << 20, device=dev)
    rows = {}
    for v in variants:
        use(v, "plain")
        for c, fn in cases.items():
            op, kname, sched, d, name, n, rt, width = meta[c]
            nb = nbytes(op, kname, sched, n)
            dev_t = device_ms(fn, "spgemm_kernel")
            how = "profiler"
            if dev_t is None:
                dev_t, how = graph_ms(fn), "graph"
            bare = call(op, kname, sched, d, bare=True, route=rt)
            r = rows.setdefault((v, name, kname, sched, rt, width), {})
            r[n] = dict(nb=nb, wrap=min(ms[v][c]), dev=dev_t,
                        bare=cuda_time_ms(bare), cold=cold_ms(fn, flush),
                        host=host_us(fn), host_bare=host_us(bare))
            lib = lib_ms[(name, n)][("addmm " if kname.startswith("acc")
                                     else "sparse.mm ")
                                    + ("f64" if sched else "f32")]
            route = "/".join(rt or sk.pick_route(
                op, kname.endswith("f64"), planes_of(kname, sched, d),
                _cin_planes(kname, sched)))
            x = r[n]
            print(f"  {v:24s} {c:36s} wrapper "
                  f"{' / '.join('%.4f' % t for t in ms[v][c])}; device "
                  f"{x['dev']:.4f} ({how}); bare {x['bare']:.4f}; cold "
                  f"{x['cold']:.4f}; host {x['host']:.1f} us a call (bare "
                  f"{x['host_bare']:.1f}); bound "
                  f"{nb / HBM_BYTES_PER_S * 1e3:.4f} (share "
                  f"{nb / HBM_BYTES_PER_S * 1e3 / min(ms[v][c]):.3f}); "
                  f"library {lib:.4f}; route {route}")
    print("spgemm fixed cost a call (us) and stream (TB/s), the line through "
          "the two N of each case  [" + smi + "]")
    for (v, name, kname, sched, rt, (tag, n0, n1)), r in rows.items():
        if n0 not in r or n1 not in r:
            continue
        pts = [r[n0], r[n1]]
        fits = {k_: fit([p["nb"] for p in pts], [p[k_] for p in pts])
                for k_ in ("wrap", "dev", "bare", "cold")}
        print(f"  {v:24s} {name:8s} {tag}{kname} {sched or 'f32':7s} "
              + (f"{rt[0]}/{rt[1]} " if rt else "") + "; ".join(
                  f"{k_} {f[0]:.1f} us {f[1]:.2f} TB/s"
                  for k_, f in fits.items())
              + f"; host {r[n0]['host']:.1f} us a call at N={n0} (bare "
                f"{r[n0]['host_bare']:.1f}), device fixed "
                f"{fits['dev'][0]:.1f} us")
    for v in variants:
        if (v, "prof") not in libs:
            print(f"  {v}: no stamps (its anchors differ)")
            continue
        lib = use(v, "prof")
        for c in cases:
            op, kname, sched, d, name, n, rt, _ = meta[c]
            if rt is not None:
                continue
            ct = 64 if sched == "split2" else 128
            print(f"  {v}: {c} phases: " + _phases(
                lib, call(op, kname, sched, d),
                ("wait", "sum", "store", "release"), -(-n // ct),
                spread=True))


def _spgemm_host_parts(sk, op, d) -> None:
    """Host microseconds a call of each step of the acc f64 split2 wrapper
    (the most operands), each step repeated on its own."""
    import torch

    bh, bl, ch, cl = d["bh"], d["bl"], d["ch"], d["cl"]
    n = bh.shape[1]
    ops = {"Bh": bh, "Bl": bl, "Ch_in": ch, "Cl_in": cl}
    lib = sk._lib()
    parts = {
        "_check (4 planes)": lambda: sk._check(op, ops, n),
        "_route": lambda: sk._route(op, True, [bh, bl], 2, None),
        "torch.empty x2": lambda: (torch.empty((op.m, n), dtype=torch.float32,
                                               device=op.device),
                                   torch.empty_like(ch)),
        "current_stream": lambda: torch.cuda.current_stream(
            op.device).cuda_stream,
        "_lib": lambda: sk._lib(),
        "fits (the kernel's)": lambda: lib.xsmm_spgemm_fits(
            1, 2, 2, op.m, op.k, op.nnz, 0, 0, 0),
        "wrapper": lambda: sk.acc_f64(op, ch, cl, bh, bl),
    }
    print("spgemm wrapper host steps, us a call: " + "; ".join(
        f"{k} {host_us(f, 2000 if k != 'wrapper' else 200):.2f}"
        for k, f in parts.items()))


def _cin_planes(kname: str, sched: Optional[str]) -> int:
    """The C_in planes kernel ``kname`` reads under ``sched``."""
    if not kname.startswith("acc"):
        return 0
    return 2 if sched and SCHED_PLANES[sched][1] else 1


def _spgemm_check(sk, v, name, op, kname, sched, d, route) -> None:
    """Kernel ``kname`` against its plain version on operands ``d``, bit
    for bit (on ``route`` where given, its launch counted there)."""
    b_lo, c_lo = SCHED_PLANES[sched] if sched else (False, False)
    bl = d["bl"] if b_lo else None
    cl = d["cl"] if c_lo else None
    kw = {} if route is None else {"route": route}
    before = dict(sk.route_launches)
    if kname == "unroll_f32":
        got, want = (sk.unroll_f32(op, d["bh"], **kw),
                     sk.unroll_f32_plain(op, d["bh"]))
    elif kname == "acc_f32":
        got, want = (sk.acc_f32(op, d["ch"], d["bh"], **kw),
                     sk.acc_f32_plain(op, d["ch"], d["bh"]))
    elif kname == "unroll_f64":
        got = sk.unroll_f64(op, d["bh"], bl, c_lo=c_lo, **kw)
        want = sk.unroll_f64_plain(op, d["bh"], bl, c_lo=c_lo)
    else:
        got = sk.acc_f64(op, d["ch"], cl, d["bh"], bl, **kw)
        want = sk.acc_f64_plain(op, d["ch"], cl, d["bh"], bl)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rt = "" if route is None else f" route {route[0]}/{route[1]}"
    for i, (g_, w_) in enumerate(zip(got, want)):
        _bits(f"{v} {name} N={d['n']} {kname} {sched or 'f32'}{rt} c{i}", g_,
              w_)
    if route is not None:
        for part in route:
            if sk.route_launches[part] != before[part] + 1:
                raise RuntimeError(f"{rt}: launch not counted on {part}")


def _smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not available"


if __name__ == "__main__":
    raise SystemExit(main())
