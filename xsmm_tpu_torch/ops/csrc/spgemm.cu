// Fixed-sparsity sparse x dense, C[M,N] = A_csr[M,K] @ B[K,N]: the four
// Hopper kernels behind xsmm_tpu_torch/ops/spgemm_kernels.py, built for
// sm_90a with a plain C interface (loaded through ctypes by
// ops/cuda_build.py).
//
// Kernels and the TPU kernels they replace (one template):
//   unroll f32  <- xsmm_tpu/ops/spgemm.py:195 CsrSpgemm._build_unroll.kernel
//   unroll f64  <- xsmm_tpu/ops/spgemm.py:233 CsrSpgemm._build_unroll.kernel64
//   acc f32     <- xsmm_tpu/ops/spgemm.py:322 CsrSpgemm._build_acc.kernel
//   acc f64     <- xsmm_tpu/ops/spgemm.py:363 CsrSpgemm._build_acc.kernel64
//
// The TPU kernels bake the CSR structure and values into the traced
// program, one kernel per structure.  Here one template computes the same
// function for every structure: the structure (row_ptr, col_idx) and the
// values (f32, or the f64 hi/lo split) are device arrays made once when the
// operator is created.  f64 is carried as f32 hi/lo planes; the schedule's
// compile-time flags say whether the B-lo plane is read (BLO) and whether
// the C-lo plane is written (CLO) or folded into one C.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32): the kernels stream B
// in and C out.  A 150x150 operator at 5 % density (nnz ~ 1125) does
// 2*nnz = 2250 flops per column against (K + M)*4 = 1200 bytes per column
// in f32, 1.9 flop/byte, far below the card's 20: bound by device memory.
//
// Design.  What it does about the bound is to read each B element and
// write each C element once, coalesced:
//   * A block owns CT = 64 neighbouring columns of N; a thread owns CPT = 2
//     of them (n0 + tx and n0 + tx + 32), so a warp's loads and stores are
//     whole 128-byte lines.
//   * Every row of C needs its own subset of B's rows, and all rows
//     together read B's rows nnz/K times.  So the block first stages its
//     [K, CT] tile of B (each plane) in shared memory, once, with every
//     copy in flight at once (cp.async, 16 bytes a copy where N % 4 == 0),
//     and the rows read it from there.  Where the tile would not leave
//     room for two blocks on an SM (planes*K*CT*4 > 113 KB, K > 452 in
//     f32) the rows read B from device memory instead (STAGED = false).
//   * The block's RG = 8 warps share the rows: warp w computes rows w,
//     w + 8, ...  Within a warp every thread reads the same structure entry
//     at the same time, a broadcast.
//   * Ragged N is masked, not padded: columns past N read column N - 1 and
//     store nothing.
//
// Numerics follow the Pallas kernels term by term, in CSR order, with
// products and sums rounded separately (__fmul_rn/__fadd_rn, no FMA
// contraction), so a kernel and its plain PyTorch version agree bit for
// bit:
//   * f32: acc = v[s]*b[c[s]], then acc = acc + v[p]*b[c[p]]; v is f32(v).
//   * f64: hi = vh*bh; lo = vl*bh (+ vh*bl when BLO) on the first term,
//     then hi = hi + vh*bh and lo = lo + (vh*bl + vl*bh) (or lo + vl*bh).
//     Out: (hi, lo) when CLO, else hi + lo.
//   * acc (beta = 1): c = c_in + acc; (ch, cl) = (ch_in + hi, cl_in + lo);
//     c = c_in + (hi + lo).  Empty rows write 0, or pass c_in through.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TX = 32;                      // threads along N: one warp
constexpr int CPT = 2;                      // columns per thread
constexpr int CT = TX * CPT;                // columns per block
constexpr int RG = 8;                       // warps (row groups) per block
constexpr size_t MAX_TILE_BYTES = 113 * 1024;  // two blocks fit an SM

template <bool F64, bool BLO, bool CLO, bool ACC, bool STAGED>
__global__ void __launch_bounds__(TX * RG)
spgemm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
              const float* __restrict__ vh, const float* __restrict__ vl,
              const float* __restrict__ bh, const float* __restrict__ bl,
              const float* __restrict__ c0_in, const float* __restrict__ c1_in,
              float* __restrict__ c0, float* __restrict__ c1, int M, int K,
              long long N, bool vec) {
  extern __shared__ __align__(16) float tile[];  // STAGED: [K][CT] bh, bl
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long n0 = (long long)blockIdx.x * CT;

  long long ncol[CPT];  // the thread's columns, clamped into [0, N)
  bool live[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const long long n = n0 + tx + j * TX;
    live[j] = n < N;
    ncol[j] = live[j] ? n : N - 1;
  }

  // where each slot reads B: the staged tile (row stride CT) or device
  // memory (row stride N)
  const float* ph;
  const float* pl;
  long long ld;
  long long off[CPT];
  if constexpr (STAGED) {
    // every load of the tile is in flight at once (cp.async), 16 bytes a
    // copy where the tile is whole and the rows are 16-byte aligned
    const int tid = ty * TX + tx;
    if (vec && n0 + CT <= N) {
      constexpr int V = CT / 4;
      for (int v = tid; v < K * V; v += TX * RG) {
        const int kk = v / V, q = 4 * (v % V);
        const long long g = (long long)kk * N + n0 + q;
        __pipeline_memcpy_async(tile + kk * CT + q, bh + g, 16);
        if constexpr (BLO)
          __pipeline_memcpy_async(tile + (K + kk) * CT + q, bl + g, 16);
      }
    } else {
      for (int v = tid; v < K * CT; v += TX * RG) {
        const int kk = v / CT, j = v % CT;
        const long long n = n0 + j < N ? n0 + j : N - 1;
        const long long g = (long long)kk * N + n;
        __pipeline_memcpy_async(tile + v, bh + g, 4);
        if constexpr (BLO)
          __pipeline_memcpy_async(tile + K * CT + v, bl + g, 4);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    ph = tile;
    pl = tile + K * CT;
    ld = CT;
#pragma unroll
    for (int j = 0; j < CPT; ++j) off[j] = tx + j * TX;
  } else {
    ph = bh;
    pl = bl;
    ld = N;
#pragma unroll
    for (int j = 0; j < CPT; ++j) off[j] = ncol[j];
  }

  for (int r = ty; r < M; r += RG) {
    const int s = __ldg(row_ptr + r), e = __ldg(row_ptr + r + 1);
    const long long orow = (long long)r * N;
    // acc: C_in is loaded before the row's terms, so its latency hides
    // behind them (clamped columns read real memory and store nothing)
    float ci0[CPT], ci1[CPT];
    if constexpr (ACC) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        ci0[j] = c0_in[orow + ncol[j]];
        if constexpr (CLO) ci1[j] = c1_in[orow + ncol[j]];
      }
    }
    if (s == e) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (!live[j]) continue;
        const long long o = orow + ncol[j];
        c0[o] = ACC ? ci0[j] : 0.f;
        if constexpr (CLO) c1[o] = ACC ? ci1[j] : 0.f;
      }
      continue;
    }
    float hi[CPT], lo[CPT];
    {
      const long long brow = (long long)__ldg(cols + s) * ld;
      const float h = __ldg(vh + s);
      const float l = F64 ? __ldg(vl + s) : 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float bhv = ph[brow + off[j]];
        hi[j] = __fmul_rn(h, bhv);
        if constexpr (F64) {
          lo[j] = __fmul_rn(l, bhv);
          if constexpr (BLO)
            lo[j] = __fadd_rn(lo[j], __fmul_rn(h, pl[brow + off[j]]));
        }
      }
    }
#pragma unroll 4
    for (int p = s + 1; p < e; ++p) {
      const long long brow = (long long)__ldg(cols + p) * ld;
      const float h = __ldg(vh + p);
      const float l = F64 ? __ldg(vl + p) : 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float bhv = ph[brow + off[j]];
        hi[j] = __fadd_rn(hi[j], __fmul_rn(h, bhv));
        if constexpr (F64) {
          if constexpr (BLO)
            lo[j] = __fadd_rn(lo[j], __fadd_rn(__fmul_rn(h, pl[brow + off[j]]),
                                               __fmul_rn(l, bhv)));
          else
            lo[j] = __fadd_rn(lo[j], __fmul_rn(l, bhv));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (!live[j]) continue;
      const long long o = orow + ncol[j];
      if constexpr (!F64 || CLO) {
        c0[o] = ACC ? __fadd_rn(ci0[j], hi[j]) : hi[j];
        if constexpr (CLO) c1[o] = ACC ? __fadd_rn(ci1[j], lo[j]) : lo[j];
      } else {
        const float sum = __fadd_rn(hi[j], lo[j]);
        c0[o] = ACC ? __fadd_rn(ci0[j], sum) : sum;
      }
    }
  }
}

template <bool F64, bool BLO, bool CLO, bool ACC>
int launch(const int* row_ptr, const int* cols, const float* vh,
           const float* vl, const float* bh, const float* bl,
           const float* c0_in, const float* c1_in, float* c0, float* c1,
           int m, int k, long long n, int device, void* stream) {
  cudaSetDevice(device);
  const dim3 grid((unsigned)((n + CT - 1) / CT)), block(TX, RG);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t tile = (size_t)(BLO ? 2 : 1) * k * CT * sizeof(float);
  // 16-byte staging copies need N % 4 == 0 and 16-byte aligned B planes
  const bool vec = n % 4 == 0 && !(((uintptr_t)bh | (uintptr_t)bl) & 15);
  if (tile <= MAX_TILE_BYTES) {
    auto kern = spgemm_kernel<F64, BLO, CLO, ACC, true>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)tile);
    kern<<<grid, block, tile, st>>>(row_ptr, cols, vh, vl, bh, bl, c0_in,
                                    c1_in, c0, c1, m, k, n, vec);
  } else {
    spgemm_kernel<F64, BLO, CLO, ACC, false><<<grid, block, 0, st>>>(
        row_ptr, cols, vh, vl, bh, bl, c0_in, c1_in, c0, c1, m, k, n, vec);
  }
  return (int)cudaGetLastError();
}

// f64: the schedule from which planes are given (bl: B-lo read; cl: C-lo
// written)
template <bool ACC>
int launch_f64(const int* row_ptr, const int* cols, const float* vh,
               const float* vl, const float* bh, const float* bl,
               const float* chin, const float* clin, float* ch, float* cl,
               int m, int k, long long n, int device, void* stream) {
  if (bl && cl)
    return launch<true, true, true, ACC>(row_ptr, cols, vh, vl, bh, bl, chin,
                                         clin, ch, cl, m, k, n, device, stream);
  if (bl)
    return launch<true, true, false, ACC>(row_ptr, cols, vh, vl, bh, bl, chin,
                                          clin, ch, cl, m, k, n, device, stream);
  if (cl)
    return launch<true, false, true, ACC>(row_ptr, cols, vh, vl, bh, bl, chin,
                                          clin, ch, cl, m, k, n, device, stream);
  return launch<true, false, false, ACC>(row_ptr, cols, vh, vl, bh, bl, chin,
                                         clin, ch, cl, m, k, n, device, stream);
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t) on
// device `device` and returns cudaGetLastError() (0 = launched).  The
// operator is (row_ptr [m+1], cols [nnz], values): f32 values for the f32
// kernels, the hi/lo split (vh, vl) for the f64 ones.  B is [k, n], C and
// C_in are [m, n], all f32, row-major and contiguous.  For f64, a null `bl`
// means the schedule reads no B-lo plane and a null `cl` that it folds the
// lo sum into `ch`.  Nothing is allocated and nothing synchronises.
extern "C" int xsmm_spgemm_unroll_f32(const int* row_ptr, const int* cols,
                                      const float* vals, const float* b,
                                      float* c, int m, int k, long long n,
                                      int device, void* stream) {
  return launch<false, false, false, false>(row_ptr, cols, vals, nullptr, b,
                                            nullptr, nullptr, nullptr, c,
                                            nullptr, m, k, n, device, stream);
}

extern "C" int xsmm_spgemm_acc_f32(const int* row_ptr, const int* cols,
                                   const float* vals, const float* cin,
                                   const float* b, float* c, int m, int k,
                                   long long n, int device, void* stream) {
  return launch<false, false, false, true>(row_ptr, cols, vals, nullptr, b,
                                           nullptr, cin, nullptr, c, nullptr,
                                           m, k, n, device, stream);
}

extern "C" int xsmm_spgemm_unroll_f64(const int* row_ptr, const int* cols,
                                      const float* vh, const float* vl,
                                      const float* bh, const float* bl,
                                      float* ch, float* cl, int m, int k,
                                      long long n, int device, void* stream) {
  return launch_f64<false>(row_ptr, cols, vh, vl, bh, bl, nullptr, nullptr,
                           ch, cl, m, k, n, device, stream);
}

extern "C" int xsmm_spgemm_acc_f64(const int* row_ptr, const int* cols,
                                   const float* vh, const float* vl,
                                   const float* chin, const float* clin,
                                   const float* bh, const float* bl, float* ch,
                                   float* cl, int m, int k, long long n,
                                   int device, void* stream) {
  return launch_f64<true>(row_ptr, cols, vh, vl, bh, bl, chin, clin, ch, cl,
                          m, k, n, device, stream);
}
