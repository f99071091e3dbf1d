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
// VMEM artifact) is not used: every block computes a 128 x 128 tile of C,
// and the plan stays with the Python handle for the registry.
//
// Design:
//   * A [BM, BK] and B [BK, BN] tiles are staged in shared memory with
//     16-byte cp.async, STAGES = 3 deep, so the loads of tile kt + 2 are in
//     flight while tile kt is multiplied.
//   * bf16/f16: a tile that lies inside the matrices, with rows that start
//     on 16 bytes, is staged by unchecked copies (a block-uniform test per
//     tile): the checked path costs more instructions than the mma.sync it
//     feeds.  (In the f32 kernel the FFMAs dwarf the staging instructions:
//     the unchecked path gained nothing there and made it spill.)
//   * Ragged M, N and K are masked in the kernel: a 16-byte chunk that
//     crosses an edge, or whose source is not 16-byte aligned (a row length
//     that is not a multiple of 16 bytes), is staged element by element
//     with zeros past the edge; rows and columns past M and N are not
//     stored.  No padded copy of A or B is made.
//   * Split-K where the tiles of C would leave SMs idle (the DeepBench
//     shapes have 14-32 of them for 132 SMs): blockIdx.z takes one of up
//     to MAX_SPLITS ranges of K, each block writes its f32 partial to a
//     workspace [splits, M, N] that the caller allocates, and a second
//     kernel sums the partials in z order and casts to the output type.
//   * f32 in: a register-blocked SIMT kernel with FFMA, full f32 (no TF32,
//     no 3xTF32), as the TPU kernel runs f32 at Precision.HIGHEST.  256
//     threads, each owning an 8 x 8 sub-tile of C (rows ty*4+i and
//     64+ty*4+i, columns tx*4+j and 64+tx*4+j, so a warp's shared-memory
//     reads of B are conflict-free runs); BK = 16; A is read from shared
//     memory four k at a time as float4.
//   * bf16/f16 in: tensor cores through mma.sync m16n8k16 with f32
//     accumulation, fragments loaded from shared memory by ldmatrix (B with
//     .trans, since B is staged k-major).  8 warps as 2 x 4, each owning a
//     64 x 32 tile of C (4 x 4 mma tiles, 64 f32 accumulators a thread);
//     BK = 64 (105 KB of stages, two blocks an SM).  Shared-memory rows are
//     padded by 16 bytes so that the eight row addresses of one ldmatrix
//     fall in different banks.  (A 128 x 256 tile with 64 x 64 warp tiles
//     and BK = 32 were both slower on the H100.)
//   * The sum is f32 in every case; the result is cast (round to nearest
//     even) to the output type at the store.  The sum order is k ascending
//     within a thread (f32) or within the tensor-core tile (bf16/f16), not
//     the TPU's or the plain version's panel order: the two agree to f32
//     rounding, not bit for bit.
// wgmma and TMA are not used here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// dtype codes of xsmm_tpu_torch/core/descriptors.py
constexpr int CODE_F32 = 1;
constexpr int CODE_BF16 = 2;
constexpr int CODE_F16 = 3;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int MAX_SPLITS = 8;
constexpr int SPLIT_ALIGN = 64;  // a split's K range is a multiple of every BK

// f32 SIMT path: elements of one stage, rows padded by 4 floats
constexpr int FBK = 16;
constexpr int FA_LD = FBK + 4;
constexpr int FB_LD = BN + 4;
constexpr int FA_ELEMS = BM * FA_LD;
constexpr int F_STAGE = FA_ELEMS + FBK * FB_LD;

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
// f32 in: register-blocked SIMT, FFMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void f32_load_tile(float* st, const float* A,
                                              const float* B, long long m0,
                                              long long n0, long long k0,
                                              int M, int N, int K, int kend) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(A);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(B);
  uint32_t* as = reinterpret_cast<uint32_t*>(st);
  uint32_t* bs = as + FA_ELEMS;
  for (int c = threadIdx.x; c < BM * FBK / 4; c += THREADS) {
    const int r = c / (FBK / 4), cc = (c % (FBK / 4)) * 4;
    stage16(as + r * FA_LD + cc, a, m0 + r, k0 + cc, M, kend, K);
  }
  for (int c = threadIdx.x; c < FBK * BN / 4; c += THREADS) {
    const int r = c / (BN / 4), cc = (c % (BN / 4)) * 4;
    stage16(bs + r * FB_LD + cc, b, k0 + r, n0 + cc, kend, N, N);
  }
}

// C (+ blockIdx.z * c_split, the split's partial) = A[:, split] @ B[split, :]
template <typename TOut>
__global__ void __launch_bounds__(THREADS, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                TOut* __restrict__ C, int M, int N, int K, int kc,
                long long c_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  int kbeg, kend;
  split_range(K, kc, &kbeg, &kend);
  const int ktiles = kend > kbeg ? (kend - kbeg + FBK - 1) / FBK : 0;
  C += blockIdx.z * c_split;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      f32_load_tile(smem + s * F_STAGE, A, B, m0, n0, kbeg + (long long)s * FBK,
                    M, N, K, kend);
    __pipeline_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < ktiles)
      f32_load_tile(smem + (nk % STAGES) * F_STAGE, A, B, m0, n0,
                    kbeg + (long long)nk * FBK, M, N, K, kend);
    __pipeline_commit();
    const float* As = smem + (kt % STAGES) * F_STAGE;
    const float* Bs = As + FA_ELEMS;
#pragma unroll
    for (int k4 = 0; k4 < FBK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        a[i] = *reinterpret_cast<const float4*>(As + row * FA_LD + k4);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + (k4 + kk) * FB_LD + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + (k4 + kk) * FB_LD + 64 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long c = n0 + (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
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

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return sms;
}

// Split-K count: enough (m, n) tiles times splits to give every SM two
// blocks, each split at least four 64-deep k tiles, at most MAX_SPLITS.
int splits_for(int m, int n, int k, int sms) {
  const long long tiles = ((long long)m + BM - 1) / BM * (((long long)n + BN - 1) / BN);
  if (tiles >= sms || tiles == 0) return 1;
  long long s = (2LL * sms + tiles - 1) / tiles;
  const long long by_k = ((long long)k + SPLIT_ALIGN - 1) / SPLIT_ALIGN / 4;
  if (s > by_k) s = by_k;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  return s < 1 ? 1 : (int)s;
}

template <typename TA, typename TOut>
int launch_gemm(void (*kern)(const TA*, const TA*, TOut*, int, int, int, int,
                             long long),
                size_t smem, const void* a, const void* b, TOut* c, int m,
                int n, int k, int splits, cudaStream_t stream) {
  const long long gy = ((long long)m + BM - 1) / BM;
  if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
  // above 48 KB of dynamic shared memory only after this; a refused launch
  // never runs
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int per = (k + splits - 1) / splits;
  const int kc = (per + SPLIT_ALIGN - 1) / SPLIT_ALIGN * SPLIT_ALIGN;
  kern<<<dim3((unsigned)((n + BN - 1) / BN), (unsigned)gy, (unsigned)splits),
         THREADS, smem, stream>>>(static_cast<const TA*>(a),
                                  static_cast<const TA*>(b), c, m, n, k, kc,
                                  splits > 1 ? (long long)m * n : 0LL);
  return (int)cudaGetLastError();
}

// One GEMM kernel for (in_code, TStore), storing TStore at c.
template <typename TStore>
int launch_in(int in_code, const void* a, const void* b, TStore* c, int m,
              int n, int k, int splits, cudaStream_t stream) {
  constexpr size_t f_smem = STAGES * F_STAGE * sizeof(float);
  constexpr size_t h_smem = STAGES * H_STAGE * sizeof(uint16_t);
  switch (in_code) {
    case CODE_F32:
      return launch_gemm<float, TStore>(gemm_f32_kernel<TStore>, f_smem, a, b,
                                        c, m, n, k, splits, stream);
    case CODE_BF16:
      return launch_gemm<uint16_t, TStore>(gemm_mma_kernel<true, TStore>,
                                           h_smem, a, b, c, m, n, k, splits,
                                           stream);
    case CODE_F16:
      return launch_gemm<uint16_t, TStore>(gemm_mma_kernel<false, TStore>,
                                           h_smem, a, b, c, m, n, k, splits,
                                           stream);
    default:
      return -1;
  }
}

template <typename TOut>
int launch_out(int in_code, const void* a, const void* b, void* c, float* work,
               int m, int n, int k, int splits, int sms, cudaStream_t stream) {
  if (splits <= 1)
    return launch_in<TOut>(in_code, a, b, static_cast<TOut*>(c), m, n, k, 1,
                           stream);
  int rc = launch_in<float>(in_code, a, b, work, m, n, k, splits, stream);
  if (rc != 0) return rc;
  const long long mn = (long long)m * n;
  long long blocks = (mn + THREADS - 1) / THREADS;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  splitk_reduce_kernel<TOut><<<(unsigned)blocks, THREADS, 0, stream>>>(
      work, static_cast<TOut*>(c), mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The split-K count xsmm_tiled_gemm takes for this call on device `device`
// (1: no workspace; else the caller passes a float workspace of
// splits * m * n elements).
extern "C" int xsmm_tiled_gemm_splits(int m, int n, int k, int device) {
  return splits_for(m, n, k, sm_count(device));
}

// C[m, n] = A[m, k] @ B[k, n], row-major and contiguous; A and B of dtype
// `in_code` (f32, bf16 or f16), C of dtype `out_code` (f32, bf16 or f16).
// `splits` must be xsmm_tiled_gemm_splits(m, n, k, device) and
// `work` a float workspace of splits * m * n elements when it is > 1.
// Launches on `stream` (a cudaStream_t) on device `device` (one kernel, or
// the split kernel and its sum) and returns cudaGetLastError() (0 =
// launched); -1 means a dtype code the kernel does not take.  k may be 0
// (C = 0).  Nothing is allocated and nothing synchronises.
extern "C" int xsmm_tiled_gemm(const void* a, const void* b, void* c,
                               float* work, int m, int n, int k, int splits,
                               int in_code, int out_code, int device,
                               void* stream) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  if (splits < 1 || splits > MAX_SPLITS || (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_code) {
    case CODE_F32:
      return launch_out<float>(in_code, a, b, c, work, m, n, k, splits, sms, st);
    case CODE_BF16:
      return launch_out<__nv_bfloat16>(in_code, a, b, c, work, m, n, k, splits,
                                       sms, st);
    case CODE_F16:
      return launch_out<__half>(in_code, a, b, c, work, m, n, k, splits, sms,
                                st);
    default:
      return -1;
  }
}
