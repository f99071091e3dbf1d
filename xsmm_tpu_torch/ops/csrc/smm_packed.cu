// Batched small GEMM on the lane-packed layout: the three Hopper kernels
// behind xsmm_tpu_torch/ops/smm_packed.py, built for sm_90a with a plain C
// interface (loaded through ctypes by ops/cuda_build.py); and, at the end,
// the natural kernel, which runs the F32 schedule on f32 operands in the
// caller's batch-first layout (its own notes).
//
// Layout, one problem per batch index b, b innermost and contiguous:
//   A [M, K, Bp], B [K, N, Bp], C [M, N, Bp]
// (the JAX package's packed layout, xsmm_tpu/ops/smm.py BatchedSMM).
//
// Kernels and the TPU kernels they replace (two templates: packed_tile_kernel
// for f32 planes, under the three schedules; packed_kernel, the first design,
// for 16-bit inputs, under F32):
//   F32         <- xsmm_tpu/ops/smm.py:193 _make_packed_kernel_f32
//   SPLIT2_FAST <- xsmm_tpu/ops/smm.py:296 _make_packed_kernel_split2_fast
//   SPLIT2      <- xsmm_tpu/ops/smm.py:251 _make_packed_kernel_split2
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32 outside the tensor
// cores) at B = 131072, 23^3, beta = 0; one f32 plane is 529*B*4 = 277 MB:
//   F32:          3 planes, 0.832 GB -> 0.248 ms (bytes)
//   SPLIT2_FAST:  4 planes, 1.11 GB  -> 0.331 ms (bytes)
//   SPLIT2:       6 planes, 1.66 GB  -> 0.497 ms (bytes)
// The FP32 work (2*23^3*B per product; 6.4 GFLOP for SPLIT2_FAST, 0.095 ms)
// is below the bytes in every case: the kernels are bound by device memory.
// K = 23 is too shallow for wgmma, and the bytes would bound a tensor-core
// version the same way.
//
// Design (not the Pallas structure: no rank-1 slab updates, no lane tiles).
// What it does about the bound is to move each A and B element from device
// memory once, coalesced, and to write each C element once.  The tile
// kernel (below, with its own notes) holds a 6 x 8 tile of C a thread for
// 32 problems a warp, with a ring of TMA stages across persistent items;
// packed_kernel, the first design, which 16-bit inputs take:
//   * A block takes P = 16 neighbouring problems and up to MAX_ROWS rows of
//     C, one thread per (problem b, row m): thread (b, m) owns
//     C[m, n0:n0+NT, b] in registers.  A warp covers two rows of the 16
//     problems, so its global accesses are whole 64-byte segments.  More
//     rows loop over row groups.  Two blocks fit an SM, so one block's
//     loads overlap the other's arithmetic.
//   * All rows of a problem need the same B, so B is not read per thread:
//     each KC-deep k chunk of A and B for the block's problems is staged in
//     shared memory by cp.async, double buffered, and every row warp reads
//     it from there.
//   * C is computed in register tiles of NT columns, looped over N (routing
//     admits N in the thousands when M*K is small).
//   * Staging moves four neighbouring problems per cp.async (8 bytes) when
//     Bp % 4 == 0, one element at a time otherwise.
//   * Any Bp: lanes with b >= Bp stage nothing and store nothing.
//
// Numerics follow the Pallas kernels term by term, in the same k order:
// products and sums are rounded separately (__fmul_rn/__fadd_rn, no FMA
// contraction), as the TPU vector unit and the plain PyTorch versions do,
// so a kernel and its plain version agree bit for bit.
//   * F32: the running sum is held in the output type.  Each product
//     f32(a)*f32(b) is rounded to the output type, then added and rounded
//     again (bf16 -> bf16 rounds at every k step; bf16 -> f32 sums in f32).
//   * SPLIT2_FAST: hi = sum ah*bh (+ c_in), lo = sum ah*bl kept apart and
//     folded into C once after the k loop.
//   * SPLIT2: ch = sum ah*bh (+ ch_in), cl = sum (ah*bl + al*bh) (+ cl_in),
//     both written out and joined in f64 by the caller.

#include <cuda.h>  // CUtensorMap and its enums (the CUDA driver API's
                   // entry point is taken through the runtime)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "tma.cuh"

namespace {

constexpr int P = 16;         // problems per block
constexpr int MAX_ROWS = 24;  // rows of C per block, one thread row each
constexpr int NT = 24;        // C columns per register tile
constexpr int KC = 8;         // k steps per staged chunk
constexpr int MIN_BLOCKS = 2; // resident blocks per SM the registers must allow

// dtype codes of xsmm_tpu_torch/core/descriptors.py
constexpr int CODE_F32 = 1;
constexpr int CODE_BF16 = 2;
constexpr int CODE_F16 = 3;

enum Sched { F32 = 0, SPLIT2_FAST = 1, SPLIT2 = 2 };

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Num<__half> {
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ __half from_f(float x) {
    return __float2half_rn(x);
  }
};

// Four neighbouring problems b..b+3 (b % 4 == 0) global -> shared.  With
// `vec` (Bp % 4 == 0 and aligned planes) one cp.async moves all four; else
// one element at a time: cp.async for 4-byte types, a plain copy for 2-byte
// ones (cp.async moves at least 4 bytes).
template <typename T>
__device__ __forceinline__ void stage4(T* dst, const T* src, long long b,
                                       long long Bp, bool vec) {
  if (vec) {
    if (b < Bp) __pipeline_memcpy_async(dst, src, 4 * sizeof(T));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (b + i < Bp) {
      if constexpr (sizeof(T) == 4) {
        __pipeline_memcpy_async(dst + i, src + i, 4);
      } else {
        dst[i] = src[i];
      }
    }
  }
}

template <int S>
struct Planes {
  static constexpr int A = (S == SPLIT2) ? 2 : 1;
  static constexpr int B = (S == F32) ? 1 : 2;
};

// Elements of one staging buffer: A [rows][KC][P], B [KC][NT][P].
__host__ __device__ __forceinline__ int buffer_elems(int rows) {
  return rows * KC * P + KC * NT * P;
}

// Stage k chunk [k0, k0 + KC) of A (rows m0..) and B (columns n0..) for the
// block's problems into `dst`, four problems per copy.  Out-of-range
// elements are not written; no live thread reads them.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* a, const T* b,
                                            int M, int N, int K, long long Bp,
                                            long long bbase, int m0, int n0,
                                            int k0, int rows, bool vec) {
  constexpr int V = P / 4;  // copies per row segment of P problems
  const int tid = threadIdx.y * P + threadIdx.x;
  const int nthreads = rows * P;
  for (int v = tid; v < rows * KC * V; v += nthreads) {
    const int row = v / (KC * V), kk = (v / V) % KC, q = 4 * (v % V);
    const int m = m0 + row, k = k0 + kk;
    if (m < M && k < K) {
      const long long g = ((long long)m * K + k) * Bp + bbase + q;
      stage4(dst + (row * KC + kk) * P + q, a + g, bbase + q, Bp, vec);
    }
  }
  T* db = dst + rows * KC * P;
  for (int v = tid; v < KC * NT * V; v += nthreads) {
    const int kk = v / (NT * V), j = (v / V) % NT, q = 4 * (v % V);
    const int k = k0 + kk, n = n0 + j;
    if (k < K && n < N) {
      const long long g = ((long long)k * N + n) * Bp + bbase + q;
      stage4(db + (kk * NT + j) * P + q, b + g, bbase + q, Bp, vec);
    }
  }
}

// The first design, for 16-bit inputs under the F32 schedule
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(P * MAX_ROWS, MIN_BLOCKS)
packed_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
              const TOut* __restrict__ c_in, TOut* __restrict__ c, int M,
              int N, int K, long long Bp, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TIn* smem = reinterpret_cast<TIn*>(smem_raw);
  const int rows = blockDim.y;
  const int a_plane = rows * KC * P;
  const int buf = buffer_elems(rows);
  const long long bbase = (long long)blockIdx.x * P;
  const long long bi = bbase + threadIdx.x;
  const int nk = (K + KC - 1) / KC;

  for (int m0 = 0; m0 < M; m0 += rows) {
    const int m = m0 + threadIdx.y;
    const bool live = m < M && bi < Bp;
    for (int n0 = 0; n0 < N; n0 += NT) {
      const long long coff = ((long long)m * N + n0) * Bp + bi;
      float acc[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool in = c_in != nullptr && live && n0 + j < N;
        acc[j] = in ? Num<TOut>::to_f(c_in[coff + (long long)j * Bp]) : 0.f;
      }
      stage_chunk(smem, a, b, M, N, K, Bp, bbase, m0, n0, 0, rows, vec);
      __pipeline_commit();
      for (int kc = 0; kc < nk; ++kc) {
        if (kc + 1 < nk) {
          stage_chunk(smem + ((kc + 1) & 1) * buf, a, b, M, N, K, Bp, bbase,
                      m0, n0, (kc + 1) * KC, rows, vec);
          __pipeline_commit();
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();
        if (live) {
          const TIn* As = smem + (kc & 1) * buf + threadIdx.y * KC * P + threadIdx.x;
          const TIn* Bs = smem + (kc & 1) * buf + a_plane + threadIdx.x;
          const int kmax = min(KC, K - kc * KC);
          for (int kk = 0; kk < kmax; ++kk) {
            const float av = Num<TIn>::to_f(As[kk * P]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (n0 + j < N) {
                const float p = Num<TOut>::round(
                    __fmul_rn(av, Num<TIn>::to_f(Bs[(kk * NT + j) * P])));
                acc[j] = Num<TOut>::round(__fadd_rn(acc[j], p));
              }
            }
          }
        }
        __syncthreads();
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (n0 + j < N) c[coff + (long long)j * Bp] = Num<TOut>::from_f(acc[j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The tile kernel, for f32 planes under every schedule (the first design,
// packed_kernel above, ran kernel 3 in 0.926 ms at 23^3, B = 131072, kernel
// 1 in 0.660 and kernel 2 in 0.480; it keeps 16-bit inputs, for which it
// measured faster, 0.540 against 0.566 ms bf16 -> f32).  What held it back
// was the shared-memory loads (two a term for six FP operations,
// each thread re-reading B for its one row) and loads that did not overlap
// the arithmetic (two stages, three k chunks a tile, the first never
// overlapped).  Here:
//   * a group of TP = 32 neighbouring problems is a warp's lanes, so every
//     shared load brings 32 distinct words and every global access is a
//     whole 128-byte line;
//   * warp (rg, cg) of the RG x CG warps holds a TR x TC tile of C (rows
//     m0 + rg*TR.., columns n0 + cg*TC..) for its lane's problem: per k it
//     loads TR values of A and TC of B (each plane) for TR*TC terms;
//   * persistent blocks walk a ring of STAGES k chunks (TKC k steps of A
//     and B each) that runs on from one item (group, row pass, column pass)
//     into the next, so the next item's first chunks are in flight during
//     this item's last arithmetic and its store;
//   * f32 planes that TMA can address (Bp % 4 == 0, planes on 16 bytes) are
//     staged by TMA: one thread puts a chunk's boxes (A [TM][TKC][TP], B
//     [TKC][TN][TP], zeros past the edges) in flight on the slot's mbarrier
//     once every warp is done with the slot, and no other thread issues a
//     load (with cp.async staging by every thread, a first version spent
//     30 % of a block's time issuing copies, with no arithmetic beside
//     them); other planes are staged by cp.async, one element a copy.
// The sum of each element runs in k order as packed_kernel's, so the bits
// are the same.
// ---------------------------------------------------------------------------
constexpr int TP = 32;           // problems a group: a warp's lanes
constexpr int TR = 6;            // rows of C a thread holds
constexpr int TC = 8;            // columns of C a thread holds
constexpr int RG = 4;            // warps down a pass (RG * TR rows)
constexpr int CG = 3;            // warps across a pass (CG * TC columns)
constexpr int TKC = 4;           // k steps a stage
constexpr int STAGES = 4;        // stages in the ring
constexpr int TM = RG * TR, TN = CG * TC, TILE_THREADS = RG * CG * 32;

// Elements of one stage: A planes [TM][TKC][TP], B planes [TKC][TN][TP].
template <int S>
__host__ __device__ constexpr int tile_stage_elems() {
  return (Planes<S>::A * TM + Planes<S>::B * TN) * TKC * TP;
}

// the tensor maps of the planes for TMA (A planes [M][K][Bp], B [K][N][Bp];
// unused planes left zero)
struct TileMaps {
  CUtensorMap a0, a1, b0, b1;
};

// Stage k chunk [k0, k0 + TKC) of A (rows m0..) and B (columns n0..) for
// group g's problems into `dst` by cp.async, one element a copy (the planes
// TMA cannot address).  Out-of-range elements are not written; no stored
// result reads them.
template <int S, typename T>
__device__ __forceinline__ void tile_stage(T* dst, const T* a0, const T* a1,
                                           const T* b0, const T* b1, int M,
                                           int N, int K, long long Bp,
                                           long long g, int m0, int n0,
                                           int k0) {
  constexpr int V = TP / 4;
  constexpr int a_plane = TM * TKC * TP, b_plane = TKC * TN * TP;
  const long long gb = g * TP;
  for (int v = threadIdx.x; v < TM * TKC * V; v += TILE_THREADS) {
    const int row = v / (TKC * V), kk = (v / V) % TKC, q = 4 * (v % V);
    const int m = m0 + row, k = k0 + kk;
    if (m < M && k < K) {
      const long long o_g = ((long long)m * K + k) * Bp + gb + q;
      const int o = (row * TKC + kk) * TP + q;
      stage4(dst + o, a0 + o_g, gb + q, Bp, false);
      if constexpr (Planes<S>::A == 2)
        stage4(dst + a_plane + o, a1 + o_g, gb + q, Bp, false);
    }
  }
  T* db = dst + Planes<S>::A * a_plane;
  for (int v = threadIdx.x; v < TKC * TN * V; v += TILE_THREADS) {
    const int kk = v / (TN * V), j = (v / V) % TN, q = 4 * (v % V);
    const int k = k0 + kk, n = n0 + j;
    if (k < K && n < N) {
      const long long o_g = ((long long)k * N + n) * Bp + gb + q;
      const int o = (kk * TN + j) * TP + q;
      stage4(db + o, b0 + o_g, gb + q, Bp, false);
      if constexpr (Planes<S>::B == 2)
        stage4(db + b_plane + o, b1 + o_g, gb + q, Bp, false);
    }
  }
}

// The same chunk by TMA: the boxes of each plane, zeros past the edges,
// completion counted on `bar` (one thread)
template <int S, typename T>
__device__ __forceinline__ void tile_stage_tma(T* dst, const TileMaps& maps,
                                               uint64_t* bar, long long g,
                                               int m0, int n0, int k0) {
  constexpr int a_plane = TM * TKC * TP, b_plane = TKC * TN * TP;
  const int gb = (int)(g * TP);
  mbar_expect_tx(bar, tile_stage_elems<S>() * sizeof(T));
  tma_load_3d(dst, &maps.a0, bar, gb, k0, m0);
  if constexpr (Planes<S>::A == 2)
    tma_load_3d(dst + a_plane, &maps.a1, bar, gb, k0, m0);
  T* db = dst + Planes<S>::A * a_plane;
  tma_load_3d(db, &maps.b0, bar, gb, n0, k0);
  if constexpr (Planes<S>::B == 2)
    tma_load_3d(db + b_plane, &maps.b1, bar, gb, n0, k0);
}

// item -> (group, m0, n0): items run group by group, row pass, column pass
__device__ __forceinline__ void tile_item(long long item, int npm, int npn,
                                          long long& g, int& m0, int& n0) {
  const long long per = (long long)npm * npn;
  g = item / per;
  const int rest = (int)(item - g * per);
  m0 = rest / npn * TM;
  n0 = rest % npn * TN;
}

template <int S, typename TOut, bool TMA>
__global__ void __launch_bounds__(TILE_THREADS, 1)
packed_tile_kernel(const __grid_constant__ TileMaps maps,
                   const float* __restrict__ a0, const float* __restrict__ a1,
                   const float* __restrict__ b0, const float* __restrict__ b1,
                   const TOut* __restrict__ c0_in,
                   const TOut* __restrict__ c1_in, TOut* __restrict__ c0,
                   TOut* __restrict__ c1, int M, int N, int K, long long Bp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int buf = tile_stage_elems<S>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * buf);
  constexpr int a_plane = TM * TKC * TP, b_plane = TKC * TN * TP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp / CG, cg = warp % CG;
  const int npm = (M + TM - 1) / TM, npn = (N + TN - 1) / TN;
  const int nk = (K + TKC - 1) / TKC;
  const long long ngroups = (Bp + TP - 1) / TP;
  const long long nitems = ngroups * npm * npn;
  const long long mine =
      blockIdx.x < nitems ? (nitems - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long nt = mine * nk;  // this block's chunks, in ring order

  // chunk t of this block into its slot
  auto stage = [&](long long t) {
    long long g;
    int m0, n0;
    tile_item(blockIdx.x + t / nk * gridDim.x, npm, npn, g, m0, n0);
    const int slot = (int)(t % STAGES);
    if constexpr (TMA)
      tile_stage_tma<S>(smem + slot * buf, maps, &full[slot], g, m0, n0,
                        (int)(t % nk) * TKC);
    else
      tile_stage<S>(smem + slot * buf, a0, a1, b0, b1, M, N, K, Bp, g, m0, n0,
                    (int)(t % nk) * TKC);
  };
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int t = 0; t < STAGES && t < nt; ++t) stage(t);
  } else {
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < nt) stage(t);
      __pipeline_commit();
    }
  }

  float acc0[TR][TC], acc1[TR][TC];
  long long g = 0;
  int m0 = 0, n0 = 0;
  bool live = false;
  for (long long t = 0; t < nt; ++t) {
    const int slot = (int)(t % STAGES);
    // -- the stage wait (cp.async: then the next stage's copies, into
    // chunk t - 1's slot)
    if constexpr (TMA) {
      mbar_wait(&full[slot], (unsigned)(t / STAGES) & 1);
    } else {
      __pipeline_wait_prior(STAGES - 2);
      __syncthreads();  // chunk t is in; every thread is done with t - 1
      if (t + STAGES - 1 < nt) stage(t + STAGES - 1);
      __pipeline_commit();
    }
    const int c = (int)(t % nk);
    if (c == 0) {
      tile_item(blockIdx.x + t / nk * gridDim.x, npm, npn, g, m0, n0);
      live = m0 + rg * TR < M && n0 + cg * TC < N;  // warp-uniform
      const long long b = g * TP + lane;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int m = m0 + rg * TR + r, n = n0 + cg * TC + j;
          const bool in = c0_in != nullptr && m < M && n < N && b < Bp;
          const long long o = ((long long)m * N + n) * Bp + b;
          acc0[r][j] = in ? Num<TOut>::to_f(c0_in[o]) : 0.f;
          acc1[r][j] = (S == SPLIT2 && in) ? Num<TOut>::to_f(c1_in[o]) : 0.f;
        }
      }
    }
    // -- the arithmetic
    if (live) {
      const float* As = smem + slot * buf + rg * TR * TKC * TP + lane;
      const float* Bs = smem + slot * buf + Planes<S>::A * a_plane +
                      cg * TC * TP + lane;
      const int kmax = min(TKC, K - c * TKC);
#pragma unroll
      for (int kk = 0; kk < TKC; ++kk) {
        if (kk < kmax) {
          float ah[TR], al[TR], bh[TC], bl[TC];
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            ah[r] = As[(r * TKC + kk) * TP];
            al[r] = S == SPLIT2 ? As[a_plane + (r * TKC + kk) * TP] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            bh[j] = Bs[(kk * TN + j) * TP];
            bl[j] = S != F32 ? Bs[b_plane + (kk * TN + j) * TP] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < TR; ++r) {
#pragma unroll
            for (int j = 0; j < TC; ++j) {
              if constexpr (S == F32) {
                const float p = Num<TOut>::round(__fmul_rn(ah[r], bh[j]));
                acc0[r][j] = Num<TOut>::round(__fadd_rn(acc0[r][j], p));
              } else {
                acc0[r][j] = __fadd_rn(acc0[r][j], __fmul_rn(ah[r], bh[j]));
                if constexpr (S == SPLIT2_FAST)
                  acc1[r][j] = __fadd_rn(acc1[r][j], __fmul_rn(ah[r], bl[j]));
                else
                  acc1[r][j] = __fadd_rn(
                      acc1[r][j], __fadd_rn(__fmul_rn(ah[r], bl[j]),
                                            __fmul_rn(al[r], bh[j])));
              }
            }
          }
        }
      }
    }
    // -- the store, after the item's last chunk
    if (c == nk - 1 && live) {
      const long long b = g * TP + lane;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int m = m0 + rg * TR + r, n = n0 + cg * TC + j;
          if (m < M && n < N && b < Bp) {
            const long long o = ((long long)m * N + n) * Bp + b;
            if constexpr (S == F32) {
              c0[o] = Num<TOut>::from_f(acc0[r][j]);
            } else if constexpr (S == SPLIT2_FAST) {
              c0[o] = __fadd_rn(acc0[r][j], acc1[r][j]);
            } else {
              c0[o] = acc0[r][j];
              c1[o] = acc1[r][j];
            }
          }
        }
      }
    }
    // -- TMA: the slot back to the ring once every warp is done with it
    if constexpr (TMA) {
      __syncthreads();
      if (threadIdx.x == 0 && t + STAGES < nt) stage(t + STAGES);
    }
  }
}

// The map of an f32 plane [d2][d1][Bp] at p, boxes of [b2][b1][TP]; elements
// past the edges read as zeros
bool plane_map(CUtensorMap* map, const void* p, long long bp, int d1, int d2,
               int b1, int b2) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)bp, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)bp * 4, (cuuint64_t)bp * 4 * d1};
  const cuuint32_t box[3] = {TP, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int S, typename TOut, bool TMA>
int launch_tile_kernel(const TileMaps& maps, const float* a0, const float* a1,
                       const float* b0, const float* b1, const TOut* c0_in,
                       const TOut* c1_in, TOut* c0, TOut* c1, int m, int n,
                       int k, long long bp, int device, cudaStream_t st) {
  const size_t smem = (size_t)STAGES * tile_stage_elems<S>() * sizeof(float) +
                      STAGES * sizeof(uint64_t);
  auto kern = packed_tile_kernel<S, TOut, TMA>;
  int per_sm = 0;
  blocks_per_sm(kern, TILE_THREADS, smem, device, &per_sm);
  const long long items = (bp + TP - 1) / TP * ((m + TM - 1) / TM) *
                          ((n + TN - 1) / TN);
  long long grid =
      (long long)(per_sm > 0 ? per_sm : 1) * device_facts(device).sms;
  if (grid > items) grid = items;
  kern<<<dim3((unsigned)grid), dim3(TILE_THREADS), smem, st>>>(
      maps, a0, a1, b0, b1, c0_in, c1_in, c0, c1, m, n, k, bp);
  return (int)cudaGetLastError();
}

// TMA where the planes are on 16 bytes with Bp % 4 == 0 (`vec`), else
// cp.async; -2 where `vec` holds and a plane's tensor map cannot be encoded
template <int S, typename TOut>
int launch_tile(const float* a0, const float* a1, const float* b0,
                const float* b1, const TOut* c0_in, const TOut* c1_in,
                TOut* c0, TOut* c1, int m, int n, int k, long long bp,
                bool vec, int device, cudaStream_t st) {
  TileMaps maps = {};
  if (!vec)
    return launch_tile_kernel<S, TOut, false>(maps, a0, a1, b0, b1, c0_in,
                                              c1_in, c0, c1, m, n, k, bp,
                                              device, st);
  if (!plane_map(&maps.a0, a0, bp, k, m, TKC, TM) ||
      (Planes<S>::A == 2 && !plane_map(&maps.a1, a1, bp, k, m, TKC, TM)) ||
      !plane_map(&maps.b0, b0, bp, n, k, TN, TKC) ||
      (Planes<S>::B == 2 && !plane_map(&maps.b1, b1, bp, n, k, TN, TKC)))
    return -2;
  return launch_tile_kernel<S, TOut, true>(maps, a0, a1, b0, b1, c0_in, c1_in,
                                           c0, c1, m, n, k, bp, device, st);
}

// The staging a launch takes, named by the caller (ops/smm_packed.py
// STAGINGS) and checked here against the planes
enum Staging {
  STAGE_TMA = 0,
  STAGE_CP_ASYNC = 1,
  STAGE_FIRST = 2,
  STAGE_BULK = 3  // the natural kernel's bulk copies
};

// f32 planes take the tile kernel, 16-bit inputs the first design; -2 where
// `staging` is not the one these planes take
template <int S, typename TIn, typename TOut>
int launch(const void* a0, const void* a1, const void* b0, const void* b1,
           const void* c0_in, const void* c1_in, void* c0, void* c1, int m,
           int n, int k, long long bp, int staging, int device, void* stream) {
  cudaSetDevice(device);
  // four-problem copies (and TMA) need Bp % 4 == 0 and planes aligned to 4
  // elements
  const uintptr_t align = 4 * sizeof(TIn) - 1;
  const bool vec = bp % 4 == 0 &&
                   !(((uintptr_t)a0 | (uintptr_t)a1 | (uintptr_t)b0 | (uintptr_t)b1) & align);
  if constexpr (sizeof(TIn) == 4) {
    if (staging != (vec ? STAGE_TMA : STAGE_CP_ASYNC)) return -2;
    return launch_tile<S, TOut>(
        static_cast<const float*>(a0), static_cast<const float*>(a1),
        static_cast<const float*>(b0), static_cast<const float*>(b1),
        static_cast<const TOut*>(c0_in), static_cast<const TOut*>(c1_in),
        static_cast<TOut*>(c0), static_cast<TOut*>(c1), m, n, k, bp, vec,
        device, static_cast<cudaStream_t>(stream));
  } else {
    static_assert(S == F32, "16-bit inputs take the F32 schedule only");
    if (staging != STAGE_FIRST) return -2;
    const int rows = m < MAX_ROWS ? m : MAX_ROWS;
    const size_t smem = 2 * (size_t)buffer_elems(rows) * sizeof(TIn);
    auto kern = packed_kernel<TIn, TOut>;
    prepare(kern, smem, device);
    kern<<<dim3((unsigned)((bp + P - 1) / P)), dim3(P, rows), smem,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TIn*>(a0), static_cast<const TIn*>(b0),
        static_cast<const TOut*>(c0_in), static_cast<TOut*>(c0), m, n, k, bp,
        vec);
    return (int)cudaGetLastError();
  }
}

template <typename TIn>
int launch_f32(int out_code, const void* a, const void* b, const void* cin,
               void* c, int m, int n, int k, long long bp, int staging,
               int device, void* stream) {
  switch (out_code) {
    case CODE_F32:
      return launch<F32, TIn, float>(a, nullptr, b, nullptr, cin, nullptr, c,
                                     nullptr, m, n, k, bp, staging, device,
                                     stream);
    case CODE_BF16:
      return launch<F32, TIn, __nv_bfloat16>(a, nullptr, b, nullptr, cin,
                                             nullptr, c, nullptr, m, n, k, bp,
                                             staging, device, stream);
    case CODE_F16:
      return launch<F32, TIn, __half>(a, nullptr, b, nullptr, cin, nullptr, c,
                                      nullptr, m, n, k, bp, staging, device,
                                      stream);
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// The natural kernel: f32 problems in the caller's batch-first layout,
//   A [Bn, M, K] ([Bn, K, M] with TA), B [Bn, K, N] ([Bn, N, K] with TB),
//   C [Bn, M, N], each problem's A, B and C contiguous.
// It replaces no TPU kernel.  BatchedSMM.__call__ on f32 tensors used to
// pack A and B into the planes above (BatchedSMM.pack_a / pack_b: two
// transposes on the card), run the tile kernel's F32 schedule and hand back
// a permuted view of C (unpack_c).  At 23^3, B = 131072 the transposes moved
// 1.11 GB a call beside the product's own 0.832 GB, and took three times
// the tile kernel's time.  This kernel fuses the pack and the unpack with
// that schedule: it reads A and B and writes C where the caller keeps them,
// each byte once.
//
// Bound on an H100 SXM at 23^3, B = 131072, beta = 0: 0.832 GB -> 0.248 ms
// (bytes); the FP32 work, 3.19 GFLOP as separate multiplies and adds, takes
// 0.095 ms at 67 TFLOP/s.
//
// Design.  TMA's tiled mode cannot address this layout (a row is 92 bytes,
// not a multiple of 16), but NAT_G = 4 problems of f32 are 16*M*K bytes of
// A: a whole group is one contiguous run that is a multiple of 16 bytes, on
// 16 bytes wherever the tensor is.
//   * A block is one warp; the persistent blocks (as many as fit the SMs)
//     walk groups g = blockIdx.x, + gridDim.x, ... through a ring of
//     NAT_SLOTS slots, each holding a group's A, B and C.  Lane 0 stages a
//     whole group by bulk copies (cp.async.bulk, one an operand) counted on
//     the slot's mbarrier; the ragged tail, and operands that are not all on
//     16 bytes, are staged by every lane with 4-byte cp.async.  A slot is
//     refilled once its group's C has left, so a group's copies are in
//     flight while the group before it is computed.
//   * Lane 8p + r computes rows r, r + 8, r + 16 of each 24-row pass of
//     problem p, NAT_NT columns of C a pass in registers: per k it loads 3
//     words of A and one word of B a column for 3 terms.  The row stride K
//     and the problem stride M*K are odd at 23^3, so the lanes' A words fall
//     in distinct banks (two ways at most), and the 8 lanes of a problem
//     read the same B word (a broadcast).
//   * The rows go back into the slot's C part, and the warp writes the
//     group's C as one contiguous run (16-byte stores for a whole group on
//     16 bytes), every store coalesced.
// Numerics are the F32 schedule's term for term (packed_tile_kernel with
// TOut = float): each product and each sum rounded (__fmul_rn/__fadd_rn, no
// FMA contraction), k ascending, the sum started from c_in (beta = 1) or 0.
// The bits are those of the pack route.
// Measured on the H100 at 700 W, 23^3, B = 131072, beta = 0: 0.303 ms (82 %
// of the bound) against 1.68 for the pack route (the transposes and kernel
// 2's 0.413) and 0.450 for torch.bmm in f32; the staging and stores alone
// take 0.285, the arithmetic alone 0.274, so each hides the other.  A first
// version whose k loop branched around each column's load (a column past N
// was skipped) ran 1.04: the load's latency stood in every column.
// ---------------------------------------------------------------------------
constexpr int NAT_G = 4;                  // problems a group
constexpr int NAT_RT = 8;                 // lanes a problem
constexpr int NAT_R = 3;                  // rows of C a lane holds a pass
constexpr int NAT_NT = 24;                // columns of C a pass
constexpr int NAT_SLOTS = 2;              // slots of a block's ring
constexpr int NAT_TM = NAT_RT * NAT_R;    // rows a pass

// `bytes` (a multiple of 16; both addresses on 16 bytes) global -> shared,
// completion counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// n words global -> shared, one 4-byte cp.async each, neighbouring lanes on
// neighbouring words
__device__ __forceinline__ void stage_words(float* dst, const float* src,
                                            int n, int lane) {
  for (int i = lane; i < n; i += 32) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// Lane r's rows of one problem: A, B, C in the slot (C holds c_in when
// `beta`), C overwritten with the result.  The k loop has no branch, so its
// loads can be issued ahead of the arithmetic: a row past M repeats row
// M - 1, a column past N (with TB) repeats column N - 1, and without TB a
// column past N reads on past the row (into the slot, or the padding after
// the ring); such terms are computed and never stored.
template <bool TA, bool TB>
__device__ __forceinline__ void natural_rows(const float* As, const float* Bs,
                                             float* Cs, bool beta, int M,
                                             int N, int K, int r) {
  for (int m0 = 0; m0 < M; m0 += NAT_TM) {
    int aoff[NAT_R];
#pragma unroll
    for (int i = 0; i < NAT_R; ++i) {
      const int m = min(m0 + r + i * NAT_RT, M - 1);
      aoff[i] = TA ? m : m * K;
    }
    for (int n0 = 0; n0 < N; n0 += NAT_NT) {
      int boff[NAT_NT];
#pragma unroll
      for (int j = 0; j < NAT_NT; ++j)
        boff[j] = TB ? min(n0 + j, N - 1) * K : n0 + j;
      float acc[NAT_R][NAT_NT];
#pragma unroll
      for (int i = 0; i < NAT_R; ++i) {
        const int m = m0 + r + i * NAT_RT;
#pragma unroll
        for (int j = 0; j < NAT_NT; ++j) {
          const int n = n0 + j;
          acc[i][j] = (beta && m < M && n < N) ? Cs[m * N + n] : 0.f;
        }
      }
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        float av[NAT_R];
#pragma unroll
        for (int i = 0; i < NAT_R; ++i) av[i] = As[aoff[i] + (TA ? k * M : k)];
        const float* brow = Bs + (TB ? k : k * N);
#pragma unroll
        for (int j = 0; j < NAT_NT; ++j) {
          const float bv = brow[boff[j]];
#pragma unroll
          for (int i = 0; i < NAT_R; ++i)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv));
        }
      }
#pragma unroll
      for (int i = 0; i < NAT_R; ++i) {
        const int m = m0 + r + i * NAT_RT;
#pragma unroll
        for (int j = 0; j < NAT_NT; ++j) {
          const int n = n0 + j;
          if (m < M && n < N) Cs[m * N + n] = acc[i][j];
        }
      }
    }
  }
}

template <bool TA, bool TB>
__global__ void __launch_bounds__(32)
natural_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const float* __restrict__ c_in, float* __restrict__ c, int M,
               int N, int K, long long nb, bool bulk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int lane = threadIdx.x;
  const int mk = M * K, kn = K * N, mn = M * N;
  const int slot_elems = NAT_G * (mk + kn + mn);  // 16-byte multiple
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NAT_SLOTS * slot_elems);
  const long long ngroups = (nb + NAT_G - 1) / NAT_G;
  const long long mine =
      blockIdx.x < ngroups ? (ngroups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // a group staged by bulk copies: whole, and every operand on 16 bytes
  auto whole = [&](long long g) { return bulk && (g + 1) * NAT_G <= nb; };

  if (lane == 0) {
    for (int s = 0; s < NAT_SLOTS; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // this block's t-th group into slot t % NAT_SLOTS; every lane commits one
  // cp.async group a t, empty where it copies nothing
  auto issue = [&](long long t) {
    if (t < mine) {
      const long long g = blockIdx.x + t * gridDim.x, p0 = g * NAT_G;
      float* dst = smem + (int)(t % NAT_SLOTS) * slot_elems;
      if (whole(g)) {
        // the slot's reads and writes by the lanes come before the bulk
        // copies write it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          uint64_t* bar = &full[t % NAT_SLOTS];
          const unsigned ab = NAT_G * mk * 4, bb = NAT_G * kn * 4,
                         cb = NAT_G * mn * 4;
          mbar_expect_tx(bar, ab + bb + (c_in != nullptr ? cb : 0));
          bulk_load(dst, a + p0 * mk, ab, bar);
          bulk_load(dst + NAT_G * mk, b + p0 * kn, bb, bar);
          if (c_in != nullptr)
            bulk_load(dst + NAT_G * (mk + kn), c_in + p0 * mn, cb, bar);
        }
      } else {
        const int np = (int)(nb - p0 < NAT_G ? nb - p0 : NAT_G);
        stage_words(dst, a + p0 * mk, np * mk, lane);
        stage_words(dst + NAT_G * mk, b + p0 * kn, np * kn, lane);
        if (c_in != nullptr)
          stage_words(dst + NAT_G * (mk + kn), c_in + p0 * mn, np * mn, lane);
      }
    }
    __pipeline_commit();
  };

  for (int s = 0; s < NAT_SLOTS; ++s) issue(s);
  const int p = lane / NAT_RT, r = lane % NAT_RT;
  for (long long t = 0; t < mine; ++t) {
    const long long g = blockIdx.x + t * gridDim.x, p0 = g * NAT_G;
    const int np = (int)(nb - p0 < NAT_G ? nb - p0 : NAT_G);
    float* slot = smem + (int)(t % NAT_SLOTS) * slot_elems;
    float* cs = slot + NAT_G * (mk + kn);
    // -- the stage wait: this lane's copies of group t, then the bulk
    // copies (a slot's earlier groups were all whole: only the last group
    // of all can be ragged)
    __pipeline_wait_prior(NAT_SLOTS - 1);
    if (whole(g)) mbar_wait(&full[t % NAT_SLOTS], (unsigned)(t / NAT_SLOTS) & 1);
    __syncwarp();
    // -- the arithmetic
    if (p < np)
      natural_rows<TA, TB>(slot + p * mk, slot + NAT_G * mk + p * kn,
                           cs + p * mn, c_in != nullptr, M, N, K, r);
    __syncwarp();
    // -- the store: the group's C, one contiguous run
    float* cg = c + p0 * mn;
    if (whole(g)) {
      const float4* src = reinterpret_cast<const float4*>(cs);
      float4* dst = reinterpret_cast<float4*>(cg);
      for (int i = lane; i < NAT_G * mn / 4; i += 32) dst[i] = src[i];
    } else {
      for (int i = lane; i < np * mn; i += 32) cg[i] = cs[i];
    }
    __syncwarp();
    issue(t + NAT_SLOTS);
  }
}

// Shared memory of a natural launch: the ring's slots, their mbarriers, and
// NAT_NT words of padding that the last slot's column reads past N may reach
size_t natural_smem(int m, int n, int k) {
  return (size_t)NAT_SLOTS * NAT_G *
             ((size_t)m * k + (size_t)k * n + (size_t)m * n) * sizeof(float) +
         NAT_SLOTS * sizeof(uint64_t) + NAT_NT * sizeof(float);
}

template <bool TA, bool TB>
int launch_natural(const float* a, const float* b, const float* cin, float* c,
                   int m, int n, int k, long long nb, bool bulk, int device,
                   cudaStream_t st) {
  const size_t smem = natural_smem(m, n, k);
  if (smem > BLOCK_SMEM_MAX) return -2;
  auto kern = natural_kernel<TA, TB>;
  int per_sm = 0;
  blocks_per_sm(kern, 32, smem, device, &per_sm);
  if (per_sm < 1) return -2;
  const long long blocks = (long long)per_sm * device_facts(device).sms;
  const long long groups = (nb + NAT_G - 1) / NAT_G;
  const long long grid = blocks < groups ? blocks : groups;
  kern<<<dim3((unsigned)grid), dim3(32), smem, st>>>(a, b, cin, c, m, n, k, nb,
                                                     bulk);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t) on
// device `device` and returns cudaGetLastError() (0 = launched); -1 means
// a dtype code the kernel does not take, -2 (nothing launched) a `staging`
// (enum Staging) other than the one the planes take, or planes whose TMA
// tensor maps cannot be encoded.  `cin` (and `clin`) are null for beta = 0.
// Nothing is allocated and nothing synchronises.
extern "C" int xsmm_packed_f32(const void* a, const void* b, const void* cin,
                               void* c, int m, int n, int k, long long bp,
                               int in_code, int out_code, int staging,
                               int device, void* stream) {
  switch (in_code) {
    case CODE_F32:
      return launch_f32<float>(out_code, a, b, cin, c, m, n, k, bp, staging,
                               device, stream);
    case CODE_BF16:
      return launch_f32<__nv_bfloat16>(out_code, a, b, cin, c, m, n, k, bp,
                                       staging, device, stream);
    case CODE_F16:
      return launch_f32<__half>(out_code, a, b, cin, c, m, n, k, bp, staging,
                                device, stream);
    default:
      return -1;
  }
}

extern "C" int xsmm_packed_split2_fast(const float* ah, const float* bh,
                                       const float* bl, const float* cin,
                                       float* c, int m, int n, int k,
                                       long long bp, int staging, int device,
                                       void* stream) {
  return launch<SPLIT2_FAST, float, float>(ah, nullptr, bh, bl, cin, nullptr, c,
                                           nullptr, m, n, k, bp, staging,
                                           device, stream);
}

extern "C" int xsmm_packed_split2(const float* ah, const float* al,
                                  const float* bh, const float* bl,
                                  const float* chin, const float* clin,
                                  float* ch, float* cl, int m, int n, int k,
                                  long long bp, int staging, int device,
                                  void* stream) {
  return launch<SPLIT2, float, float>(ah, al, bh, bl, chin, clin, ch, cl, m, n,
                                      k, bp, staging, device, stream);
}

// The natural kernel on nb problems: A [nb, M, K] ([nb, K, M] with trans_a),
// B [nb, K, N] ([nb, N, K] with trans_b), C [nb, M, N]; `staging` is
// STAGE_BULK where every operand starts on 16 bytes, else STAGE_CP_ASYNC.
// -2 (nothing launched) for another staging, or a ring that does not fit a
// block's shared memory.
extern "C" int xsmm_natural_f32(const float* a, const float* b,
                                const float* cin, float* c, int m, int n,
                                int k, long long nb, int trans_a, int trans_b,
                                int staging, int device, void* stream) {
  cudaSetDevice(device);
  const bool bulk = !(((uintptr_t)a | (uintptr_t)b | (uintptr_t)cin |
                       (uintptr_t)c) & 15);
  if (staging != (bulk ? STAGE_BULK : STAGE_CP_ASYNC)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (trans_a)
    return trans_b ? launch_natural<true, true>(a, b, cin, c, m, n, k, nb,
                                                bulk, device, st)
                   : launch_natural<true, false>(a, b, cin, c, m, n, k, nb,
                                                 bulk, device, st);
  return trans_b ? launch_natural<false, true>(a, b, cin, c, m, n, k, nb, bulk,
                                               device, st)
                 : launch_natural<false, false>(a, b, cin, c, m, n, k, nb,
                                                bulk, device, st);
}
