// Tiled large GEMM, C[M,N] = A[M,K] @ B[K,N], all row-major: the Hopper
// kernel behind xsmm_tpu_torch/ops/tiled_gemm_kernels.py, built for sm_90a
// with a plain C interface (loaded through ctypes by ops/cuda_build.py).
//
// It replaces xsmm_tpu/ops/tiled_gemm.py:83 _matmul_kernel: grid
// (mi, ni, ki), an f32 accumulator zeroed at ki = 0 and stored, cast to
// the output type, at the last ki; the inputs padded to the tile plan.
//
// Bound on an H100 SXM at 4096^3 (2 * 4096^3 = 137 GFLOP; A, B and C move
// 100 MB in bf16, 201 MB in f32):
//   f32 in:   67 TFLOP/s FP32 outside the tensor cores -> 2.05 ms (operations)
//   bf16 in:  989 TFLOP/s dense on the tensor cores   -> 0.139 ms (operations)
// Both are bound by arithmetic at that size; the DeepBench shapes of
// samples/xgemm_driver.py (N = 64 or 128) are bound by their bytes.
//
// The TPU kernel's sequential ki grid axis carries the accumulator in VMEM
// scratch from one grid step to the next.  Blocks on the card run in
// parallel and in no order, so here ki is a loop inside each block with the
// block's C tile in registers.  The TPU tile plan (1024 x 1024 x 512, a
// VMEM artifact) is not used, and stays with the Python handle for the
// registry.
//
// Routes (chosen in Python, tiled_gemm_kernels.pick_route, and passed in):
//   * ROUTE_TMA, bf16/f16 operands TMA can address (bases on 16 bytes, rows
//     of A and B multiples of 16 bytes): gemm_wgmma_kernel.  A producer
//     warpgroup (one thread) keeps a ring of A [128 x 64] and B [64 x 256]
//     tiles in flight with TMA, 128-byte swizzle, one full and one empty
//     mbarrier a stage (4 stages, 192 KB); two consumer warpgroups each run
//     wgmma m64n256k16 on a 64-row slab, A k-major and B n-major (wgmma's
//     transpose bit: no transposed copy of B), and release a stage when the
//     next one's products are issued.  setmaxnreg moves registers from the
//     producer (40) to the consumers (232).  Columns of C <= 128 take
//     128-wide tiles (6 stages).  TMA zero-fills past the edges; the
//     epilogue casts and stores with masks at M and N.  (128 x 128 tiles
//     were slower at 4096^3 on the H100.)
//   * ROUTE_MMA, the other 16-bit operands: gemm_mma_kernel, mma.sync
//     m16n8k16 fed by ldmatrix from a 3-stage cp.async ring (the first
//     route, 0.49 ms at 4096^3).
//   * ROUTE_SIMT, f32: FFMA, full f32 (no TF32, no 3xTF32), as the TPU
//     kernel runs f32 at Precision.HIGHEST (gemm_f32_kernel, below).
//
// Design of the other pieces:
//   * Ragged M, N and K are masked in the kernels: a 16-byte chunk that
//     crosses an edge, or whose source is not 16-byte aligned, is staged
//     element by element with zeros past the edge; rows and columns past M
//     and N are not stored.  No padded copy of A or B is made.
//   * Split-K where the tiles of C would leave SMs idle (the DeepBench
//     shapes have 14-32 of them for 132 SMs): blockIdx.z takes one of up
//     to MAX_SPLITS ranges of K, each block writes its f32 partial to a
//     workspace [splits, M, N] that the caller allocates, and a second
//     kernel sums the partials in z order and casts to the output type.
//   * mma.sync route: a tile inside the matrices, with rows that start on
//     16 bytes, is staged by unchecked copies; 8 warps as 2 x 4, each
//     owning a 64 x 32 tile of C (4 x 4 mma tiles); BK = 64 (105 KB of
//     stages, two blocks an SM); shared-memory rows padded by 16 bytes so
//     that the eight row addresses of one ldmatrix fall in different banks.
//   * The sum is f32 in every case; the result is cast (round to nearest
//     even) to the output type at the store.  The sum order is k ascending
//     within a thread (f32) or within the tensor-core tile (bf16/f16), not
//     the TPU's or the plain version's panel order: the two agree to f32
//     rounding, not bit for bit.

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point is
                   // fetched at run time, so nothing links against libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "tma.cuh"

namespace {

// dtype codes of xsmm_tpu_torch/core/descriptors.py
constexpr int CODE_F32 = 1;
constexpr int CODE_BF16 = 2;
constexpr int CODE_F16 = 3;

// routes (tiled_gemm_kernels.ROUTES): the f32 SIMT kernel, the cp.async +
// mma.sync kernel, the TMA + wgmma kernel
constexpr int ROUTE_SIMT = 0;
constexpr int ROUTE_MMA = 1;
constexpr int ROUTE_TMA = 2;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int MAX_SPLITS = 8;
constexpr int SPLIT_ALIGN = 64;  // a split's K range is a multiple of every BK

// f32 SIMT path: k of a tile, blocks an SM it is built for
constexpr int FBK = 16;
constexpr int F32_BLOCKS = 2;

// bf16/f16 tensor-core path: 16-bit elements of one stage, rows padded by 8
constexpr int HBK = 64;
constexpr int HA_LD = HBK + 8;
constexpr int HB_LD = BN + 8;
constexpr int HA_ELEMS = BM * HA_LD;
constexpr int H_STAGE = HA_ELEMS + HBK * HB_LD;

template <typename T>
struct Out;

template <>
struct Out<float> {
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Out<__half> {
  static __device__ __forceinline__ __half from_f(float x) {
    return __float2half_rn(x);
  }
};

// Stage the 16 bytes at row r, elements [c, c + E) of a row-major matrix
// with leading dimension ld into shared memory at dst; rows >= `rows` and
// columns >= `cols` read as zeros.  R is the element's bit type (uint32_t
// for f32, uint16_t for bf16/f16).
template <typename R>
__device__ __forceinline__ void stage16(R* dst, const R* g, long long r,
                                        long long c, long long rows,
                                        long long cols, long long ld) {
  constexpr int E = 16 / sizeof(R);
  if (r < rows && c + E <= cols) {
    const R* src = g + r * ld + c;
    if (!((uintptr_t)src & 15)) {
      __pipeline_memcpy_async(dst, src, 16);
      return;
    }
  }
  // an edge or a misaligned row: element by element, zeros past the edge
#pragma unroll
  for (int e = 0; e < E; ++e)
    dst[e] = (r < rows && c + e < cols) ? g[r * ld + c + e] : R(0);
}

// The K range [*kbeg, *kend) of split blockIdx.z, kc columns each.
__device__ __forceinline__ void split_range(int K, int kc, int* kbeg,
                                            int* kend) {
  *kbeg = blockIdx.z * kc;
  *kend = min(K, *kbeg + kc);
}

// ---------------------------------------------------------------------------
// f32 in: SIMT, FFMA
// ---------------------------------------------------------------------------

// Full f32, k ascending within a thread.  A's tile is stored k-major
// (transposed on its way through registers), so that a thread's eight rows
// at one k are two float4 reads; warp w of the 2 x 4 warps owns a 64 x 32
// tile of C, lane (tr, tc) = (lane / 4, lane % 4) its rows tr*4 + {0..3}
// and 32 + tr*4 + {0..3}, columns tc*4 + {0..3} and 16 + tc*4 + {0..3}: a
// warp reads 128 bytes of A and 64 of B a k, one shared-memory wavefront
// each.  The next k tile is read from global memory into registers while
// this one is multiplied (two stages in shared memory, one barrier a
// tile).  (The first design, 16 x 16 threads of 8 x 8 with A row-major in a
// 3-stage cp.async ring, read 6 wavefronts a k a warp and ran 3.7 ms at
// 4096^3.)
constexpr int WT_LDA = BM + 4;  // k-major A: rows of BM (+4: fewer conflicts
                                // in the transposing stores)
constexpr int WT_LDB = BN + 4;
constexpr int WT_STAGE = FBK * WT_LDA + FBK * WT_LDB;

// the k tile at k0 into registers: two float4 of A (rows t/4 and t/4 + 64,
// k (t%4)*4 .. +3), two of B (k rows t/32 and t/32 + 8, columns (t%32)*4
// .. +3); zeros past the edges
__device__ __forceinline__ void wt_fetch(float4 (&ra)[2], float4 (&rb)[2],
                                         const float* A, const float* B,
                                         long long m0, long long n0,
                                         long long k0, int M, int N, int K,
                                         int kend, bool aligned) {
  const int t = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = m0 + t / 4 + 64 * h, k = k0 + (t % 4) * 4;
    if (aligned && r < M && k + 4 <= kend) {
      ra[h] = *reinterpret_cast<const float4*>(A + r * K + k);
    } else {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = r < M && k + j < kend ? A[r * K + k + j] : 0.f;
      ra[h] = make_float4(e[0], e[1], e[2], e[3]);
    }
    const long long kb = k0 + t / 32 + 8 * h, c = n0 + (t % 32) * 4;
    if (aligned && kb < kend && c + 4 <= N) {
      rb[h] = *reinterpret_cast<const float4*>(B + kb * N + c);
    } else {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = kb < kend && c + j < N ? B[kb * N + c + j] : 0.f;
      rb[h] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

// the fetched tile into a stage: A transposed to [k][m], B as it is
__device__ __forceinline__ void wt_store(float* st, const float4 (&ra)[2],
                                         const float4 (&rb)[2]) {
  const int t = threadIdx.x;
  float* as = st;
  float* bs = st + FBK * WT_LDA;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = t / 4 + 64 * h, k = (t % 4) * 4;
    as[(k + 0) * WT_LDA + m] = ra[h].x;
    as[(k + 1) * WT_LDA + m] = ra[h].y;
    as[(k + 2) * WT_LDA + m] = ra[h].z;
    as[(k + 3) * WT_LDA + m] = ra[h].w;
    *reinterpret_cast<float4*>(bs + (t / 32 + 8 * h) * WT_LDB + (t % 32) * 4) =
        rb[h];
  }
}

// C (+ blockIdx.z * c_split, the split's partial) = A[:, split] @ B[split, :]
template <typename TOut>
__global__ void __launch_bounds__(THREADS, F32_BLOCKS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   TOut* __restrict__ C, int M, int N, int K, int kc,
                   long long c_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const int tr = lane >> 2, tc = lane & 3;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  int kbeg, kend;
  split_range(K, kc, &kbeg, &kend);
  const int ktiles = kend > kbeg ? (kend - kbeg + FBK - 1) / FBK : 0;
  const bool aligned = !(((uintptr_t)A | (uintptr_t)B) & 15) && !(K & 3) &&
                       !(N & 3);
  C += blockIdx.z * c_split;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra[2], rb[2];
  if (ktiles > 0) {
    wt_fetch(ra, rb, A, B, m0, n0, kbeg, M, N, K, kend, aligned);
    wt_store(smem, ra, rb);
  }
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const bool more = kt + 1 < ktiles;
    if (more)  // in flight while tile kt is multiplied
      wt_fetch(ra, rb, A, B, m0, n0, kbeg + (long long)(kt + 1) * FBK, M, N,
               K, kend, aligned);
    const float* as = smem + (kt & 1) * WT_STAGE;
    const float* bs = as + FBK * WT_LDA;
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * WT_LDA + wm * 64 + tr * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * WT_LDA + wm * 64 + 32 + tr * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * WT_LDB + wn * 32 + tc * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * WT_LDB + wn * 32 + 16 + tc * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) wt_store(smem + ((kt + 1) & 1) * WT_STAGE, ra, rb);
    __syncthreads();  // tile kt + 1 is in; every thread is done with kt
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + wm * 64 + (i < 4 ? 0 : 32) + tr * 4 + (i & 3);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = n0 + wn * 32 + (j < 4 ? 0 : 16) + tc * 4 + (j & 3);
      if (c < N) C[r * N + c] = Out<TOut>::from_f(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16/f16 in: mma.sync m16n8k16 on the tensor cores, f32 accumulation
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint16_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const uint16_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a @ b for one 16 x 8 x 16 tile (row-major A fragment, column B)
template <bool BF16>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  if constexpr (BF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Stage the A [BM, HBK] and B [HBK, BN] tiles at (m0, k0) and (k0, n0).
// `aligned`: A, B and their rows start on 16 bytes, so a tile that lies
// inside the matrices and the split moves by unchecked 16-byte copies.
__device__ __forceinline__ void h_load_tile(uint16_t* st, const uint16_t* A,
                                            const uint16_t* B, long long m0,
                                            long long n0, long long k0, int M,
                                            int N, int K, int kend,
                                            bool aligned) {
  uint16_t* bs = st + HA_ELEMS;
  if (aligned && m0 + BM <= M && n0 + BN <= N && k0 + HBK <= kend) {
#pragma unroll
    for (int c = threadIdx.x; c < BM * HBK / 8; c += THREADS) {
      const int r = c / (HBK / 8), cc = (c % (HBK / 8)) * 8;
      __pipeline_memcpy_async(st + r * HA_LD + cc, A + (m0 + r) * K + k0 + cc,
                              16);
    }
#pragma unroll
    for (int c = threadIdx.x; c < HBK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      __pipeline_memcpy_async(bs + r * HB_LD + cc,
                              B + (k0 + r) * N + n0 + cc, 16);
    }
    return;
  }
  for (int c = threadIdx.x; c < BM * HBK / 8; c += THREADS) {
    const int r = c / (HBK / 8), cc = (c % (HBK / 8)) * 8;
    stage16(st + r * HA_LD + cc, A, m0 + r, k0 + cc, M, kend, K);
  }
  for (int c = threadIdx.x; c < HBK * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    stage16(bs + r * HB_LD + cc, B, k0 + r, n0 + cc, kend, N, N);
  }
}

// C (+ blockIdx.z * c_split, the split's partial) = A[:, split] @ B[split, :]
template <bool BF16, typename TOut>
__global__ void __launch_bounds__(THREADS)
gemm_mma_kernel(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
                TOut* __restrict__ C, int M, int N, int K, int kc,
                long long c_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  int kbeg, kend;
  split_range(K, kc, &kbeg, &kend);
  const int ktiles = kend > kbeg ? (kend - kbeg + HBK - 1) / HBK : 0;
  const bool aligned = !(((uintptr_t)A | (uintptr_t)B) & 15) && !(K & 7) &&
                       !(N & 7);
  C += blockIdx.z * c_split;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      h_load_tile(smem + s * H_STAGE, A, B, m0, n0, kbeg + (long long)s * HBK,
                  M, N, K, kend, aligned);
    __pipeline_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < ktiles)
      h_load_tile(smem + (nk % STAGES) * H_STAGE, A, B, m0, n0,
                  kbeg + (long long)nk * HBK, M, N, K, kend, aligned);
    __pipeline_commit();
    const uint16_t* As = smem + (kt % STAGES) * H_STAGE;
    const uint16_t* Bs = As + HA_ELEMS;
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], As + (wm * 64 + mt * 16 + (lane & 15)) * HA_LD + kk +
                            (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, Bs + (kk + (lane & 15)) * HB_LD + wn * 32 + np * 16 +
                             (lane >> 4) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16816<BF16>(acc[mt][nt], af[mt], bf[nt]);
    }
  }

  // accumulator fragment: elements 0, 1 at (g, 2t), (g, 2t + 1); 2, 3 eight
  // rows below
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long c = n0 + wn * 32 + nt * 8 + 2 * t;
        if (c < N) C[r * N + c] = Out<TOut>::from_f(acc[mt][nt][2 * h]);
        if (c + 1 < N) C[r * N + c + 1] = Out<TOut>::from_f(acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16/f16 in, TMA route: wgmma on tiles that TMA brings through an mbarrier
// ring.  Warpgroup 0 is the producer (one thread issues the copies); the
// two consumer warpgroups each multiply a 64-row slab of the block's C tile.
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;        // rows of C a block: two slabs of 64
constexpr int WG_BK = 64;         // k a stage: one 128-byte swizzle row of A
constexpr int WG_BN_WIDE = 256;   // columns of C a block where N > 128
constexpr int WG_BN_NARROW = 128; // where N <= 128
constexpr int WG_STAGES_WIDE = 4;
constexpr int WG_STAGES_NARROW = 6;
constexpr int WG_THREADS = 384;   // producer warpgroup + two consumers
constexpr int WG_CONSUMERS = 256; // threads that release a stage
constexpr int WG_SLAB = 64 * 128; // bytes of a 64-row (or 64-column) slab
// B's descriptor (n-major, 128-byte swizzle): the leading byte offset steps
// from one 64-column slab to the next, the stride byte offset from one group
// of 8 k rows to the next
constexpr int WG_B_LBO = WG_SLAB;
constexpr int WG_B_SBO = 1024;

template <int BN>
struct WgCfg {
  static constexpr int STAGES = BN == WG_BN_WIDE ? WG_STAGES_WIDE
                                                 : WG_STAGES_NARROW;
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + WG_BK * BN * 2;
  // the stages, the full and empty barriers, and room to align to 1024
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES +
                                 2 * STAGES * sizeof(uint64_t) + 1024;
};

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// The wgmma operand lists: accumulator registers d[0 .. n/2) of one
// m64nNk16 product, and their PTX names.
#define WG_ACC8(i)                                                     \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC64(i)                                                    \
  WG_ACC8(i), WG_ACC8(i + 8), WG_ACC8(i + 16), WG_ACC8(i + 24),        \
      WG_ACC8(i + 32), WG_ACC8(i + 40), WG_ACC8(i + 48), WG_ACC8(i + 56)
#define WG_REGS64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_REGS128 \
    WG_REGS64 ", " \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
    "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
// d += A (64 x 16, k-major: tnspA 0) @ B (16 x N, n-major: tnspB 1)
template <int BN, bool BF16>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tile<256, true>(float (&d)[128],
                                                     uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS128
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : WG_ACC64(0), WG_ACC64(64)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile<256, false>(float (&d)[128],
                                                      uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {" WG_REGS128
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : WG_ACC64(0), WG_ACC64(64)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile<128, true>(float (&d)[64],
                                                     uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS64
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : WG_ACC64(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile<128, false>(float (&d)[64],
                                                      uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" WG_REGS64
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : WG_ACC64(0)
      : "l"(da), "l"(db), "r"(1));
}

// two neighbouring elements of a C row, cast to TOut (TMA route: N is a
// multiple of 8 and c even, so the pair is aligned and inside or outside
// together)
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// C (+ blockIdx.z * c_split, the split's partial) = A[:, split] @ B[split, :]
// with A and B read through the tensor maps ta ([M, K], boxes 128 x 64) and
// tb ([K, N], boxes 64 x 64), both with the 128-byte swizzle.
template <int BN, bool BF16, typename TOut>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, TOut* __restrict__ C,
                  int M, int N, int K, int kc, long long c_split) {
  using Cfg = WgCfg<BN>;
  constexpr int S = Cfg::STAGES;
  extern __shared__ unsigned char wg_raw[];
  // the swizzle repeats every 1024 bytes: stages start on 1024
  unsigned char* base = wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * Cfg::STAGE_BYTES);
  uint64_t* empty = full + S;
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * BN;
  int kbeg, kend;
  split_range(K, kc, &kbeg, &kend);
  const int ktiles = kend > kbeg ? (kend - kbeg + WG_BK - 1) / WG_BK : 0;
  C += blockIdx.z * c_split;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: k tile kt into stage kt % S once its last reader let go
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        unsigned char* st = base + s * Cfg::STAGE_BYTES;
        const int k0 = kbeg + kt * WG_BK;
        mbar_expect_tx(&full[s], Cfg::STAGE_BYTES);
        tma_load_2d(st, &ta, &full[s], k0, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + Cfg::A_BYTES + c * WG_SLAB, &tb, &full[s],
                      n0 + 64 * c, k0);
      }
    }
  } else {
    // -- consumers: slab (wg - 1) of the C tile in registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int slab = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % S;
      mbar_wait(&full[s], (kt / S) & 1);
      const unsigned char* st = base + s * Cfg::STAGE_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        // A: 64 rows of 128 bytes, k-major, 8-row groups 1024 bytes apart,
        // 16 k (32 bytes) a step; B: 64-column slabs WG_SLAB apart, 8-row
        // groups 1024 bytes apart, 16 k rows (2048 bytes) a step
        const uint64_t da = wg_desc(st + slab * WG_SLAB + kk * 32, 16, 1024);
        const uint64_t db =
            wg_desc(st + Cfg::A_BYTES + kk * 2048, WG_B_LBO, WG_B_SBO);
        wgmma_tile<BN, BF16>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (kt > 0) {  // tile kt - 1's products are done: its stage is free
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        mbar_arrive(&empty[(kt - 1) % S]);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // accumulator fragment of warp w of the warpgroup: rows 16 w + g and
    // 16 w + g + 8; d[4j], d[4j+1] at columns 8j + 2t, 8j + 2t + 1 of the
    // first, d[4j+2], d[4j+3] of the second
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = (long long)m0 + slab * 64 + w * 16 + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c < N) store_pair(C + r * N + c, acc[4 * j + 2 * h],
                              acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// C = sum over z of W[z] (z ascending), cast to the output type
template <typename TOut>
__global__ void __launch_bounds__(THREADS)
splitk_reduce_kernel(const float* __restrict__ W, TOut* __restrict__ C,
                     long long mn, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = W[i];
    for (int z = 1; z < splits; ++z) s += W[z * mn + i];
    C[i] = Out<TOut>::from_f(s);
  }
}

// Split-K count: enough (m, n) tiles of bm x bn times splits to give every
// SM two blocks, each split at least four 64-deep k tiles, at most
// MAX_SPLITS.
int splits_for(int m, int n, int k, int bn, int sms) {
  const long long tiles = ((long long)m + BM - 1) / BM * (((long long)n + bn - 1) / bn);
  if (tiles >= sms || tiles == 0) return 1;
  long long s = (2LL * sms + tiles - 1) / tiles;
  const long long by_k = ((long long)k + SPLIT_ALIGN - 1) / SPLIT_ALIGN / 4;
  if (s > by_k) s = by_k;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  return s < 1 ? 1 : (int)s;
}

// columns of C a block of `route` takes
int block_n(int route, int n) {
  return route == ROUTE_TMA && n > WG_BN_NARROW ? WG_BN_WIDE : BN;
}

// K columns a split takes: a multiple of every BK
int split_cols(int k, int splits) {
  const int per = (k + splits - 1) / splits;
  return (per + SPLIT_ALIGN - 1) / SPLIT_ALIGN * SPLIT_ALIGN;
}

template <typename TA, typename TOut>
int launch_gemm(void (*kern)(const TA*, const TA*, TOut*, int, int, int, int,
                             long long),
                size_t smem, const void* a, const void* b, TOut* c, int m,
                int n, int k, int splits, int device, cudaStream_t stream) {
  const long long gy = ((long long)m + BM - 1) / BM;
  if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
  // above 48 KB of dynamic shared memory only after this; a refused launch
  // never runs
  const cudaError_t rc = prepare(kern, smem, device);
  if (rc != cudaSuccess) return (int)rc;
  kern<<<dim3((unsigned)((n + BN - 1) / BN), (unsigned)gy, (unsigned)splits),
         THREADS, smem, stream>>>(static_cast<const TA*>(a),
                                  static_cast<const TA*>(b), c, m, n, k,
                                  split_cols(k, splits),
                                  splits > 1 ? (long long)m * n : 0LL);
  return (int)cudaGetLastError();
}

// The tensor map of a row-major [rows, cols] 16-bit matrix at p, boxes of
// box_rows x 64 with the 128-byte swizzle; elements past the edges read as
// zeros.
bool make_map(CUtensorMap* map, const void* p, int rows, int cols,
              int box_rows, bool bf16) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map,
             bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             2, const_cast<void*>(p), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes base addresses on 16 bytes and row strides that are multiples
// of 16 bytes (8 elements of 16 bits)
bool tma_aligned(const void* a, const void* b, int n, int k) {
  return !(((uintptr_t)a | (uintptr_t)b) & 15) && k > 0 && !(k & 7) &&
         !(n & 7);
}

template <int BN_, bool BF16, typename TOut>
int launch_wgmma_bn(const CUtensorMap& ta, const CUtensorMap& tb, TOut* c,
                    int m, int n, int k, int splits, int device,
                    cudaStream_t stream) {
  const long long gy = ((long long)m + WG_BM - 1) / WG_BM;
  if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
  auto kern = gemm_wgmma_kernel<BN_, BF16, TOut>;
  constexpr size_t smem = WgCfg<BN_>::SMEM;
  const cudaError_t rc = prepare(kern, smem, device);
  if (rc != cudaSuccess) return (int)rc;
  kern<<<dim3((unsigned)((n + BN_ - 1) / BN_), (unsigned)gy, (unsigned)splits),
         WG_THREADS, smem, stream>>>(ta, tb, c, m, n, k, split_cols(k, splits),
                                     splits > 1 ? (long long)m * n : 0LL);
  return (int)cudaGetLastError();
}

template <bool BF16, typename TOut>
int launch_wgmma(const void* a, const void* b, TOut* c, int m, int n, int k,
                 int splits, int device, cudaStream_t stream) {
  if (!tma_aligned(a, b, n, k)) return -2;
  CUtensorMap ta, tb;
  if (!make_map(&ta, a, m, k, WG_BM, BF16) ||
      !make_map(&tb, b, k, n, WG_BK, BF16))
    return (int)cudaErrorInvalidValue;
  if (block_n(ROUTE_TMA, n) == WG_BN_WIDE)
    return launch_wgmma_bn<WG_BN_WIDE, BF16, TOut>(ta, tb, c, m, n, k, splits,
                                                   device, stream);
  return launch_wgmma_bn<WG_BN_NARROW, BF16, TOut>(ta, tb, c, m, n, k, splits,
                                                   device, stream);
}

// One GEMM kernel for (in_code, route, TStore), storing TStore at c.
template <typename TStore>
int launch_in(int in_code, int route, const void* a, const void* b, TStore* c,
              int m, int n, int k, int splits, int device,
              cudaStream_t stream) {
  constexpr size_t h_smem = STAGES * H_STAGE * sizeof(uint16_t);
  constexpr size_t f_smem = 2 * WT_STAGE * sizeof(float);
  if (in_code != CODE_F32 && in_code != CODE_BF16 && in_code != CODE_F16)
    return -1;
  if ((route == ROUTE_SIMT) != (in_code == CODE_F32)) return -1;
  switch (route) {
    case ROUTE_SIMT:
      return launch_gemm<float, TStore>(gemm_f32_kernel<TStore>, f_smem, a, b,
                                        c, m, n, k, splits, device, stream);
    case ROUTE_MMA:
      return in_code == CODE_BF16
                 ? launch_gemm<uint16_t, TStore>(gemm_mma_kernel<true, TStore>,
                                                 h_smem, a, b, c, m, n, k,
                                                 splits, device, stream)
                 : launch_gemm<uint16_t, TStore>(
                       gemm_mma_kernel<false, TStore>, h_smem, a, b, c, m, n,
                       k, splits, device, stream);
    case ROUTE_TMA:
      return in_code == CODE_BF16
                 ? launch_wgmma<true, TStore>(a, b, c, m, n, k, splits,
                                              device, stream)
                 : launch_wgmma<false, TStore>(a, b, c, m, n, k, splits,
                                               device, stream);
    default:
      return -1;
  }
}

template <typename TOut>
int launch_out(int in_code, int route, const void* a, const void* b, void* c,
               float* work, int m, int n, int k, int splits, int device,
               cudaStream_t stream) {
  if (splits <= 1)
    return launch_in<TOut>(in_code, route, a, b, static_cast<TOut*>(c), m, n,
                           k, 1, device, stream);
  int rc = launch_in<float>(in_code, route, a, b, work, m, n, k, splits,
                            device, stream);
  if (rc != 0) return rc;
  const long long mn = (long long)m * n;
  const int sms = device_facts(device).sms;
  long long blocks = (mn + THREADS - 1) / THREADS;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  splitk_reduce_kernel<TOut><<<(unsigned)blocks, THREADS, 0, stream>>>(
      work, static_cast<TOut*>(c), mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The split-K count xsmm_tiled_gemm takes for this call on `route` on
// device `device` (1: no workspace; else the caller passes a float
// workspace of splits * m * n elements).
extern "C" int xsmm_tiled_gemm_splits(int m, int n, int k, int route,
                                      int device) {
  return splits_for(m, n, k, block_n(route, n), device_facts(device).sms);
}

// C[m, n] = A[m, k] @ B[k, n], row-major and contiguous; A and B of dtype
// `in_code` (f32, bf16 or f16), C of dtype `out_code` (f32, bf16 or f16),
// through `route`: ROUTE_SIMT for f32 in, ROUTE_MMA or ROUTE_TMA for 16-bit
// in.  `splits` must be xsmm_tiled_gemm_splits(m, n, k, route, device) and
// `work` a float workspace of splits * m * n elements when it is > 1.
// Launches on `stream` (a cudaStream_t) on device `device` (one kernel, or
// the split kernel and its sum) and returns cudaGetLastError() (0 =
// launched); -1 means a dtype code or a route the kernel does not take
// with it; -2 that ROUTE_TMA was asked for operands TMA cannot address
// (base addresses off 16 bytes, rows not a multiple of 16 bytes, or k = 0),
// and nothing was launched.  k may be 0 (C = 0) on the other routes.
// Nothing is allocated and nothing synchronises.
extern "C" int xsmm_tiled_gemm(const void* a, const void* b, void* c,
                               float* work, int m, int n, int k, int splits,
                               int in_code, int out_code, int route,
                               int device, void* stream) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (splits < 1 || splits > MAX_SPLITS || (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case CODE_F32:
      return launch_out<float>(in_code, route, a, b, c, work, m, n, k, splits,
                               device, st);
    case CODE_BF16:
      return launch_out<__nv_bfloat16>(in_code, route, a, b, c, work, m, n, k,
                                       splits, device, st);
    case CODE_F16:
      return launch_out<__half>(in_code, route, a, b, c, work, m, n, k, splits,
                                device, st);
    default:
      return -1;
  }
}
