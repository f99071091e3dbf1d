// Batched small GEMM on the lane-packed layout: the three Hopper kernels
// behind xsmm_tpu_torch/ops/smm_packed.py, built for sm_90a with a plain C
// interface (loaded through ctypes by ops/cuda_build.py).
//
// Layout, one problem per batch index b, b innermost and contiguous:
//   A [M, K, Bp], B [K, N, Bp], C [M, N, Bp]
// (the JAX package's packed layout, xsmm_tpu/ops/smm.py BatchedSMM).
//
// Kernels and the TPU kernels they replace (one template, three schedules):
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
// memory once, coalesced, and to write each C element once:
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
//     admits N in the thousands when M*K is small); the split schedules keep
//     a second NT-wide tile for the lo sum.
//   * Staging moves four neighbouring problems per cp.async (16 bytes for
//     f32) when Bp % 4 == 0, one element at a time otherwise.
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Elements of one staging buffer: A planes [rows][KC][P], B planes [KC][NT][P].
template <int S>
__host__ __device__ __forceinline__ int buffer_elems(int rows) {
  return Planes<S>::A * rows * KC * P + Planes<S>::B * KC * NT * P;
}

// Stage k chunk [k0, k0 + KC) of A (rows m0..) and B (columns n0..) for the
// block's problems into `dst`, four problems per copy.  Out-of-range
// elements are not written; no live thread reads them.
template <int S, typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* a0, const T* a1,
                                            const T* b0, const T* b1, int M,
                                            int N, int K, long long Bp,
                                            long long bbase, int m0, int n0,
                                            int k0, int rows, bool vec) {
  constexpr int V = P / 4;  // copies per row segment of P problems
  const int tid = threadIdx.y * P + threadIdx.x;
  const int nthreads = rows * P;
  const int a_plane = rows * KC * P;
  for (int v = tid; v < rows * KC * V; v += nthreads) {
    const int row = v / (KC * V), kk = (v / V) % KC, q = 4 * (v % V);
    const int m = m0 + row, k = k0 + kk;
    if (m < M && k < K) {
      const long long g = ((long long)m * K + k) * Bp + bbase + q;
      const int o = (row * KC + kk) * P + q;
      stage4(dst + o, a0 + g, bbase + q, Bp, vec);
      if constexpr (Planes<S>::A == 2)
        stage4(dst + a_plane + o, a1 + g, bbase + q, Bp, vec);
    }
  }
  constexpr int b_plane = KC * NT * P;
  T* db = dst + Planes<S>::A * a_plane;
  for (int v = tid; v < KC * NT * V; v += nthreads) {
    const int kk = v / (NT * V), j = (v / V) % NT, q = 4 * (v % V);
    const int k = k0 + kk, n = n0 + j;
    if (k < K && n < N) {
      const long long g = ((long long)k * N + n) * Bp + bbase + q;
      const int o = (kk * NT + j) * P + q;
      stage4(db + o, b0 + g, bbase + q, Bp, vec);
      if constexpr (Planes<S>::B == 2)
        stage4(db + b_plane + o, b1 + g, bbase + q, Bp, vec);
    }
  }
}

template <int S, typename TIn, typename TOut>
__global__ void __launch_bounds__(P * MAX_ROWS, MIN_BLOCKS)
packed_kernel(const TIn* __restrict__ a0, const TIn* __restrict__ a1,
              const TIn* __restrict__ b0, const TIn* __restrict__ b1,
              const TOut* __restrict__ c0_in, const TOut* __restrict__ c1_in,
              TOut* __restrict__ c0, TOut* __restrict__ c1, int M, int N,
              int K, long long Bp, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TIn* smem = reinterpret_cast<TIn*>(smem_raw);
  const int rows = blockDim.y;
  const int a_plane = rows * KC * P;
  constexpr int b_plane = KC * NT * P;
  const int buf = buffer_elems<S>(rows);
  const long long bbase = (long long)blockIdx.x * P;
  const long long bi = bbase + threadIdx.x;
  const int nk = (K + KC - 1) / KC;

  for (int m0 = 0; m0 < M; m0 += rows) {
    const int m = m0 + threadIdx.y;
    const bool live = m < M && bi < Bp;
    for (int n0 = 0; n0 < N; n0 += NT) {
      const long long coff = ((long long)m * N + n0) * Bp + bi;
      float acc0[NT], acc1[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool in = c0_in != nullptr && live && n0 + j < N;
        acc0[j] = in ? Num<TOut>::to_f(c0_in[coff + (long long)j * Bp]) : 0.f;
        acc1[j] = (S == SPLIT2 && in) ? Num<TOut>::to_f(c1_in[coff + (long long)j * Bp])
                                      : 0.f;
      }
      stage_chunk<S>(smem, a0, a1, b0, b1, M, N, K, Bp, bbase, m0, n0, 0, rows,
                     vec);
      __pipeline_commit();
      for (int c = 0; c < nk; ++c) {
        if (c + 1 < nk) {
          stage_chunk<S>(smem + ((c + 1) & 1) * buf, a0, a1, b0, b1, M, N, K,
                         Bp, bbase, m0, n0, (c + 1) * KC, rows, vec);
          __pipeline_commit();
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();
        if (live) {
          const TIn* As = smem + (c & 1) * buf + threadIdx.y * KC * P + threadIdx.x;
          const TIn* Bs = smem + (c & 1) * buf + Planes<S>::A * a_plane + threadIdx.x;
          const int kmax = min(KC, K - c * KC);
          for (int kk = 0; kk < kmax; ++kk) {
            const float ah = Num<TIn>::to_f(As[kk * P]);
            const float al = (S == SPLIT2) ? Num<TIn>::to_f(As[a_plane + kk * P]) : 0.f;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (n0 + j < N) {
                const float bh = Num<TIn>::to_f(Bs[(kk * NT + j) * P]);
                if constexpr (S == F32) {
                  const float p = Num<TOut>::round(__fmul_rn(ah, bh));
                  acc0[j] = Num<TOut>::round(__fadd_rn(acc0[j], p));
                } else {
                  const float bl = Num<TIn>::to_f(Bs[b_plane + (kk * NT + j) * P]);
                  acc0[j] = __fadd_rn(acc0[j], __fmul_rn(ah, bh));
                  if constexpr (S == SPLIT2_FAST)
                    acc1[j] = __fadd_rn(acc1[j], __fmul_rn(ah, bl));
                  else
                    acc1[j] = __fadd_rn(acc1[j], __fadd_rn(__fmul_rn(ah, bl),
                                                           __fmul_rn(al, bh)));
                }
              }
            }
          }
        }
        __syncthreads();
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (n0 + j < N) {
            const long long o = coff + (long long)j * Bp;
            if constexpr (S == F32) {
              c0[o] = Num<TOut>::from_f(acc0[j]);
            } else if constexpr (S == SPLIT2_FAST) {
              c0[o] = __fadd_rn(acc0[j], acc1[j]);
            } else {
              c0[o] = acc0[j];
              c1[o] = acc1[j];
            }
          }
        }
      }
    }
  }
}

template <int S, typename TIn, typename TOut>
int launch(const void* a0, const void* a1, const void* b0, const void* b1,
           const void* c0_in, const void* c1_in, void* c0, void* c1, int m,
           int n, int k, long long bp, int device, void* stream) {
  cudaSetDevice(device);
  const int rows = m < MAX_ROWS ? m : MAX_ROWS;
  const size_t smem = 2 * (size_t)buffer_elems<S>(rows) * sizeof(TIn);
  // four-problem copies need Bp % 4 == 0 and planes aligned to 4 elements
  const uintptr_t align = 4 * sizeof(TIn) - 1;
  const bool vec = bp % 4 == 0 &&
                   !(((uintptr_t)a0 | (uintptr_t)a1 | (uintptr_t)b0 | (uintptr_t)b1) & align);
  auto kern = packed_kernel<S, TIn, TOut>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<dim3((unsigned)((bp + P - 1) / P)), dim3(P, rows), smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TIn*>(a0), static_cast<const TIn*>(a1),
      static_cast<const TIn*>(b0), static_cast<const TIn*>(b1),
      static_cast<const TOut*>(c0_in), static_cast<const TOut*>(c1_in),
      static_cast<TOut*>(c0), static_cast<TOut*>(c1), m, n, k, bp, vec);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_f32(int out_code, const void* a, const void* b, const void* cin,
               void* c, int m, int n, int k, long long bp, int device,
               void* stream) {
  switch (out_code) {
    case CODE_F32:
      return launch<F32, TIn, float>(a, nullptr, b, nullptr, cin, nullptr, c,
                                     nullptr, m, n, k, bp, device, stream);
    case CODE_BF16:
      return launch<F32, TIn, __nv_bfloat16>(a, nullptr, b, nullptr, cin,
                                             nullptr, c, nullptr, m, n, k, bp,
                                             device, stream);
    case CODE_F16:
      return launch<F32, TIn, __half>(a, nullptr, b, nullptr, cin, nullptr, c,
                                      nullptr, m, n, k, bp, device, stream);
    default:
      return -1;
  }
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t) on
// device `device` and returns cudaGetLastError() (0 = launched); -1 means
// a dtype code the kernel does not take.  `cin` (and `clin`) are null for
// beta = 0.  Nothing is allocated and nothing synchronises.
extern "C" int xsmm_packed_f32(const void* a, const void* b, const void* cin,
                               void* c, int m, int n, int k, long long bp,
                               int in_code, int out_code, int device,
                               void* stream) {
  switch (in_code) {
    case CODE_F32:
      return launch_f32<float>(out_code, a, b, cin, c, m, n, k, bp, device, stream);
    case CODE_BF16:
      return launch_f32<__nv_bfloat16>(out_code, a, b, cin, c, m, n, k, bp,
                                       device, stream);
    case CODE_F16:
      return launch_f32<__half>(out_code, a, b, cin, c, m, n, k, bp, device, stream);
    default:
      return -1;
  }
}

extern "C" int xsmm_packed_split2_fast(const float* ah, const float* bh,
                                       const float* bl, const float* cin,
                                       float* c, int m, int n, int k,
                                       long long bp, int device, void* stream) {
  return launch<SPLIT2_FAST, float, float>(ah, nullptr, bh, bl, cin, nullptr, c,
                                           nullptr, m, n, k, bp, device, stream);
}

extern "C" int xsmm_packed_split2(const float* ah, const float* al,
                                  const float* bh, const float* bl,
                                  const float* chin, const float* clin,
                                  float* ch, float* cl, int m, int n, int k,
                                  long long bp, int device, void* stream) {
  return launch<SPLIT2, float, float>(ah, al, bh, bl, chin, clin, ch, cl, m, n,
                                      k, bp, device, stream);
}
