// Packed batched linear algebra on the lane-packed layout: the four Hopper
// kernels behind xsmm_tpu_torch/ops/packed_kernels.py, built for sm_90a with
// a plain C interface (loaded through ctypes by ops/cuda_build.py).
//
// Layout, one problem per batch index b, b innermost and contiguous (the JAX
// package's packed layout, xsmm_tpu/ops/packed.py):
//   GETRF: A, LU [M, N, Bp];  TRSM: A [SM, SM, Bp], B, X [SM, SN, Bp]
// Any Bp: lanes with b >= Bp load nothing and store nothing; nothing is
// padded.
//
// Entry points and the TPU kernels they replace:
//   xsmm_getrf_unrolled <- xsmm_tpu/ops/packed.py:66  _getrf_kernel_unrolled
//   xsmm_getrf_loop     <- xsmm_tpu/ops/packed.py:104 _getrf_kernel
//   xsmm_trsm_unrolled  <- xsmm_tpu/ops/packed.py:196 _trsm_kernel_unrolled
//   xsmm_trsm_loop      <- xsmm_tpu/ops/packed.py:219 _trsm_kernel
//
// Arithmetic, term by term as the Pallas kernels and the plain PyTorch
// versions, every product and sum rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn: no FMA contraction), so a kernel equals its plain version bit
// for bit:
//   * getrf_unrolled: per pivot k one reciprocal, l = a[i,k] * (1/a[k,k]),
//     then a[i,j] -= l * a[k,j] on the trailing block; stops at k + 1 >= M.
//   * getrf_loop: the same LU with l = a[i,k] / a[k,k] (division).
//   * trsm_unrolled: right-looking; row i of X is scaled by 1/a[i,i] (unless
//     unit), then x[r] -= a[r,i] * x[i] for the rows r > i.
//   * trsm_loop: left-looking; x[i] = (b[i] - s) / a[i,i] with
//     s = sum_{r<i} a[i,r] * x[r] summed from 0 in r order.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32), each input read once and
// each output written once; trsm needs only tril(A), SM(SM+1)/2 elements:
//   getrf 16x16,   B = 131072: 268 MB -> 0.080 ms (bytes; 0.36 GFLOP)
//   trsm 16/16,    B = 131072: 340 MB -> 0.101 ms (bytes)
//   getrf 125x125, B = 4096:   512 MB -> 0.153 ms (bytes); 5.3 GFLOP, 0.080 ms
//   trsm 125/125,  B = 4096:   641 MB -> 0.191 ms (bytes); 8.0 GFLOP, 0.119 ms
// Keeping multiply and subtract apart halves the FP32 issue rate, so the
// 125 cases meet a compute floor near their byte bounds.
//
// Design.  The pivot (row) loop is sequential; problems are independent.
//   * Small sizes (max(M, N) <= 64 for getrf, SM <= 64 for trsm): the TPU
//     unrolls the loop at trace time; here one template per size bucket
//     NB = 8, 16, 32, 64 unrolls it at compile time, the runtime sizes masked
//     inside the bucket, so each thread's row (getrf) or column of X (trsm)
//     lives in registers with constant indices.
//     - getrf: one thread per (problem, row), P neighbouring problems a block
//       (threadIdx.x), so a warp's loads are whole 32-128 byte segments.  At
//       step k the thread of row k publishes its row in shared memory [NB][P]
//       (no bank conflicts) to the rows below.
//     - trsm: one thread per (problem, column of X); a warp is 32 (16 at
//       NB = 64) neighbouring problems of one column, so every load of B and
//       X is a whole line.  The lower triangle of A for the block's problems
//       is staged in shared memory [SM(SM+1)/2][P] once; read from the pack
//       by each of the 16 column warps, A's lines crossed L1 and L2 16 times
//       and the kernel ran at 0.19 of its bound (0.62 ms at 16/16, B =
//       131072; staged: 0.18 ms).  The columns are independent after that
//       one barrier.
//   * Larger sizes: one block per problem (trsm: per problem and chunk of up
//     to 128 columns of X), the matrix (and the chunk of X) in dynamic shared
//     memory, the block's threads spread over the trailing update (getrf) or
//     over the columns of X (trsm).  Each element read from the pack lands in
//     a sector of its own; consecutive blockIdx are consecutive problems, so
//     blocks that run together share lines in L2.  The same templates take
//     kernel 11's or 13's arithmetic when the runtime knob (getrf_unroll)
//     sends a size above 64 to them.

#include <cuda_runtime.h>

namespace {

constexpr int SHARED_MAX = 232448;  // bytes of shared memory a block may have
constexpr int TRSM_CW = 128;        // columns of X a block of the shared trsm takes
constexpr int GETRF_THREADS = 256;  // threads of the shared getrf

// problems a block of the register getrf takes: at most 512 threads of NB rows
template <int NB>
struct Reg {
  static constexpr int P = NB <= 16 ? 32 : 512 / NB;
};

// problems (P) and columns of X (CY) a block of the register trsm takes: 512
// threads up to NB = 32; 256 at NB = 64, which leaves a thread 255 registers
// and the lower triangle of A for 16 problems (133 KB) room in shared memory
template <int NB>
struct TrsmReg {
  static constexpr int P = NB <= 32 ? 32 : 16;
  static constexpr int CY = 16;
};

__device__ __forceinline__ long long at(int i, int j, int n, long long bp,
                                        long long b) {
  return ((long long)i * n + j) * bp + b;
}

// ---------------------------------------------------------------------------
// Kernel 11, max(M, N) <= NB: one thread per (problem, row), row in registers.
// ---------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(512)
getrf_reg(const float* __restrict__ a, float* __restrict__ o, int m, int n,
          long long bp) {
  constexpr int P = Reg<NB>::P;
  __shared__ float prow[NB][P];
  const int x = threadIdx.x, i = threadIdx.y;
  const long long b = (long long)blockIdx.x * P + x;
  const bool live = b < bp;
  float r[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    r[j] = (live && j < n) ? a[at(i, j, n, bp, b)] : 0.f;
  const int kmax = min(m, n);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k < kmax && k + 1 < m) {  // block-uniform
      if (i == k) {
#pragma unroll
        for (int j = k; j < NB; ++j) prow[j][x] = r[j];
      }
      __syncthreads();
      if (i > k) {
        const float l = __fmul_rn(r[k], __frcp_rn(prow[k][x]));
        r[k] = l;
#pragma unroll
        for (int j = k + 1; j < NB; ++j)
          if (j < n) r[j] = __fsub_rn(r[j], __fmul_rn(l, prow[j][x]));
      }
      __syncthreads();
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) o[at(i, j, n, bp, b)] = r[j];
  }
}

// ---------------------------------------------------------------------------
// Kernel 12 (RECIP = false), and kernel 11 above the register buckets (RECIP
// = true): one block per problem, the matrix in shared memory [M][N].
// ---------------------------------------------------------------------------
template <bool RECIP>
__global__ void __launch_bounds__(GETRF_THREADS)
getrf_shared(const float* __restrict__ a, float* __restrict__ o, int m, int n,
             long long bp) {
  extern __shared__ float s[];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tx = tid & 31, ty = tid >> 5, ny = nt >> 5;
  for (int e = tid; e < m * n; e += nt) s[e] = a[(long long)e * bp + b];
  __syncthreads();
  const int kmax = min(m, n);
  for (int k = 0; k < kmax && k + 1 < m; ++k) {
    const float piv = s[k * n + k];
    // the multipliers, stored in column k below the pivot
    for (int i = k + 1 + tid; i < m; i += nt) {
      const float v = s[i * n + k];
      s[i * n + k] = RECIP ? __fmul_rn(v, __frcp_rn(piv)) : __fdiv_rn(v, piv);
    }
    __syncthreads();
    // the trailing block: a warp walks a row, 32 columns at a time
    for (int i = k + 1 + ty; i < m; i += ny) {
      const float l = s[i * n + k];
      for (int j = k + 1 + tx; j < n; j += 32)
        s[i * n + j] = __fsub_rn(s[i * n + j], __fmul_rn(l, s[k * n + j]));
    }
    __syncthreads();
  }
  for (int e = tid; e < m * n; e += nt) o[(long long)e * bp + b] = s[e];
}

// ---------------------------------------------------------------------------
// Kernel 13, SM <= NB: one thread per (problem, column of X), X's column in
// registers; the lower triangle of A for the block's P problems is staged in
// shared memory [SM(SM+1)/2][P] once, with whole-line loads.
// ---------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(TrsmReg<NB>::P * TrsmReg<NB>::CY)
trsm_reg(const float* __restrict__ a, const float* __restrict__ bm,
         float* __restrict__ xo, int sm, int sn, long long bp, bool unit) {
  constexpr int P = TrsmReg<NB>::P;
  extern __shared__ float as[];
  const int x = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * P, b = b0 + x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int nthreads = P * blockDim.y;
  for (int t = threadIdx.y * P + x; t < sm * sm * P; t += nthreads) {
    const int e = t / P, q = t % P, r = e / sm, i = e % sm;
    if (i <= r && b0 + q < bp)
      as[(r * (r + 1) / 2 + i) * P + q] = a[(long long)e * bp + b0 + q];
  }
  __syncthreads();
  if (b >= bp || j >= sn) return;
  float xv[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) xv[i] = i < sm ? bm[at(i, j, sn, bp, b)] : 0.f;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    if (i < sm) {
      float xi = xv[i];
      if (!unit) {
        xi = __fmul_rn(xi, __frcp_rn(as[(i * (i + 1) / 2 + i) * P + x]));
        xv[i] = xi;
      }
#pragma unroll
      for (int r = i + 1; r < NB; ++r)
        if (r < sm)
          xv[r] = __fsub_rn(xv[r],
                            __fmul_rn(as[(r * (r + 1) / 2 + i) * P + x], xi));
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (i < sm) xo[at(i, j, sn, bp, b)] = xv[i];
}

// ---------------------------------------------------------------------------
// Kernel 14 (UNROLLED = false), and kernel 13 above the register buckets
// (UNROLLED = true): one block per (problem, chunk of cw columns of X), A
// [SM][SM] and the chunk X [SM][cw] in shared memory, one thread a column.
// ---------------------------------------------------------------------------
template <bool UNROLLED>
__global__ void __launch_bounds__(TRSM_CW)
trsm_shared(const float* __restrict__ a, const float* __restrict__ bm,
            float* __restrict__ xo, int sm, int sn, long long bp, bool unit) {
  extern __shared__ float s[];
  const int cw = blockDim.x;
  float* as = s;            // [sm][sm]
  float* xs = s + sm * sm;  // [sm][cw]
  const long long b = blockIdx.x;
  const int t = threadIdx.x, j0 = blockIdx.y * cw;
  for (int e = t; e < sm * sm; e += cw) as[e] = a[(long long)e * bp + b];
  for (int e = t; e < sm * cw; e += cw) {
    const int r = e / cw, c = e % cw;
    xs[e] = j0 + c < sn ? bm[at(r, j0 + c, sn, bp, b)] : 0.f;
  }
  __syncthreads();
  if (j0 + t < sn) {
    if (UNROLLED) {
      for (int i = 0; i < sm; ++i) {
        float xi = xs[i * cw + t];
        if (!unit) {
          xi = __fmul_rn(xi, __frcp_rn(as[i * sm + i]));
          xs[i * cw + t] = xi;
        }
        for (int r = i + 1; r < sm; ++r)
          xs[r * cw + t] = __fsub_rn(xs[r * cw + t], __fmul_rn(as[r * sm + i], xi));
      }
    } else {
      for (int i = 0; i < sm; ++i) {
        float acc = 0.f;
        for (int r = 0; r < i; ++r)
          acc = __fadd_rn(acc, __fmul_rn(as[i * sm + r], xs[r * cw + t]));
        float xi = __fsub_rn(xs[i * cw + t], acc);
        if (!unit) xi = __fdiv_rn(xi, as[i * sm + i]);
        xs[i * cw + t] = xi;
      }
    }
  }
  __syncthreads();
  for (int e = t; e < sm * cw; e += cw) {
    const int r = e / cw, c = e % cw;
    if (j0 + c < sn) xo[at(r, j0 + c, sn, bp, b)] = xs[e];
  }
}

int bucket(int size) {
  return size <= 8 ? 8 : size <= 16 ? 16 : size <= 32 ? 32 : size <= 64 ? 64 : 0;
}

template <int NB>
void launch_getrf_reg(const float* a, float* o, int m, int n, long long bp,
                      cudaStream_t st) {
  constexpr int P = Reg<NB>::P;
  getrf_reg<NB><<<dim3((unsigned)((bp + P - 1) / P)), dim3(P, m), 0, st>>>(
      a, o, m, n, bp);
}

template <bool RECIP>
int launch_getrf_shared(const float* a, float* o, int m, int n, long long bp,
                        cudaStream_t st) {
  const size_t smem = (size_t)m * n * sizeof(float);
  if (smem > SHARED_MAX) return -2;
  auto kern = getrf_shared<RECIP>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<dim3((unsigned)bp), dim3(GETRF_THREADS), smem, st>>>(a, o, m, n, bp);
  return 0;
}

template <int NB>
void launch_trsm_reg(const float* a, const float* b, float* x, int sm, int sn,
                     long long bp, bool unit, cudaStream_t st) {
  constexpr int P = TrsmReg<NB>::P, CY = TrsmReg<NB>::CY;
  const int cy = sn < CY ? sn : CY;
  const size_t smem = (size_t)sm * (sm + 1) / 2 * P * sizeof(float);
  auto kern = trsm_reg<NB>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<dim3((unsigned)((bp + P - 1) / P), (unsigned)((sn + cy - 1) / cy)),
         dim3(P, cy), smem, st>>>(a, b, x, sm, sn, bp, unit);
}

template <bool UNROLLED>
int launch_trsm_shared(const float* a, const float* b, float* x, int sm, int sn,
                       long long bp, bool unit, cudaStream_t st) {
  const int cw = sn >= TRSM_CW ? TRSM_CW : (sn + 31) / 32 * 32;
  const size_t smem = ((size_t)sm * sm + (size_t)sm * cw) * sizeof(float);
  if (smem > SHARED_MAX) return -2;
  auto kern = trsm_shared<UNROLLED>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kern<<<dim3((unsigned)bp, (unsigned)((sn + cw - 1) / cw)), dim3(cw), smem,
         st>>>(a, b, x, sm, sn, bp, unit);
  return 0;
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t) on device
// `device` and returns cudaGetLastError() (0 = launched); -2 means the sizes
// need more shared memory than a block has, and nothing was launched (the
// only check of it: cuda_build.launch raises it as ValueError).
// Nothing is allocated and nothing synchronises.  Sizes are >= 1.
extern "C" int xsmm_getrf_unrolled(const float* a, float* o, int m, int n,
                                   long long bp, int device, void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bucket(m > n ? m : n)) {
    case 8: launch_getrf_reg<8>(a, o, m, n, bp, st); break;
    case 16: launch_getrf_reg<16>(a, o, m, n, bp, st); break;
    case 32: launch_getrf_reg<32>(a, o, m, n, bp, st); break;
    case 64: launch_getrf_reg<64>(a, o, m, n, bp, st); break;
    default:
      if (launch_getrf_shared<true>(a, o, m, n, bp, st)) return -2;
  }
  return (int)cudaGetLastError();
}

extern "C" int xsmm_getrf_loop(const float* a, float* o, int m, int n,
                               long long bp, int device, void* stream) {
  cudaSetDevice(device);
  if (launch_getrf_shared<false>(a, o, m, n, bp, static_cast<cudaStream_t>(stream)))
    return -2;
  return (int)cudaGetLastError();
}

extern "C" int xsmm_trsm_unrolled(const float* a, const float* b, float* x,
                                  int sm, int sn, long long bp, int unit,
                                  int device, void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bucket(sm)) {
    case 8: launch_trsm_reg<8>(a, b, x, sm, sn, bp, unit != 0, st); break;
    case 16: launch_trsm_reg<16>(a, b, x, sm, sn, bp, unit != 0, st); break;
    case 32: launch_trsm_reg<32>(a, b, x, sm, sn, bp, unit != 0, st); break;
    case 64: launch_trsm_reg<64>(a, b, x, sm, sn, bp, unit != 0, st); break;
    default:
      if (launch_trsm_shared<true>(a, b, x, sm, sn, bp, unit != 0, st)) return -2;
  }
  return (int)cudaGetLastError();
}

extern "C" int xsmm_trsm_loop(const float* a, const float* b, float* x, int sm,
                              int sn, long long bp, int unit, int device,
                              void* stream) {
  cudaSetDevice(device);
  if (launch_trsm_shared<false>(a, b, x, sm, sn, bp, unit != 0,
                                static_cast<cudaStream_t>(stream)))
    return -2;
  return (int)cudaGetLastError();
}
