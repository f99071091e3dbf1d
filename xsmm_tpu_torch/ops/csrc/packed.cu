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
//   xsmm_trsm_unrolled_upper, xsmm_trsm_loop_upper: the same kernels on the
//     upper triangle (the backward solve U X = B on getrf's packed factors),
//     which the TPU kernels reach only through flipped and repacked copies
//     (xsmm_tpu/ops/packed.py _solve)
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
//   * the upper variants (trsm_reg_upper, trsm_shared_upper): the same
//     arithmetic on the reversed order, row i -> SM-1-i: backward
//     substitution on triu(A), x[i] from the last row up, each sum taken
//     from column SM-1 down.  They read triu(A), B and X in place by that
//     index: no copy, no flip.  A flipped lower solve (the path the JAX
//     package takes for uplo U) gives the same bits.
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
//   * Larger sizes, getrf (kernel 12; also kernel 11 where the knob sends
//     it): at 65 <= min(M, N), max(M, N) <= 128, the "tile" route
//     (getrf_tile): one block per problem, right-looking over a register
//     tile, one barrier a step, clusters for the load and store.  Every
//     other size, and kernel 11 above 64, takes the "shared" route
//     (getrf_shared): one block per problem, the matrix in dynamic shared
//     memory, the block's threads spread over the trailing update.  Each
//     element read from the pack lands in a sector of its own; consecutive
//     blockIdx are consecutive problems, so blocks that run together share
//     lines in L2.
//   * Larger sizes, trsm (kernel 14; the first design, one thread a column
//     running the left-looking sum, A and X in 126 KB of shared memory, one
//     block an SM, ran 5.29 ms at 125/125, B = 4096): one block per problem
//     and chunk of up to TRSM_CW columns, right-looking over a register tile
//     (see trsm_shared), tril(A) alone in shared memory so two blocks fit an
//     SM, and clusters of TRSM_CLUSTER neighbouring problems that load and
//     store whole 32-byte sectors of the pack through distributed shared
//     memory.  The same templates take
//     kernel 11's or 13's arithmetic when the runtime knob (getrf_unroll)
//     sends a size above 64 to them.
//   * trsm routes: each solve (kernels 13 and 14, lower and upper) takes one
//     of two routes, named by the caller (packed_kernels.trsm_route, from the
//     sizes alone): "chunk", the block a problem above (trsm_shared), and
//     "narrow", the register trsm (trsm_reg): one thread per (problem,
//     column of X), a warp 32 neighbouring problems: the register buckets
//     above (either arithmetic) at small SM with many columns
//     (narrow_bucket), else the triangle streamed from the pack
//     (trsm_reg<0, ...>), at any SM up to 256.  At one column
//     the chunk route ran a block of 8 warps a problem in which one lane held
//     the column, 125 barriers a solve, 24-30x its byte bound (29.8 ms for
//     the lower unit solve at 125/1, B = 131072, against 1.252).  What
//     bounds the streamed solve is the bytes of tril(A), read once, so the
//     design is about keeping enough of them in flight: x lives in shared
//     memory [SM][32] a warp (500 bytes a thread at 125, so about 13 warps
//     an SM), and each thread loads its triangle in chunks of a row's terms
//     into two banks of registers, one chunk in flight while it sums the
//     other; a warp's load is one 128-byte line of the pack.  No barrier, no
//     lane idle, no test inside a full chunk.  (A first design that took the
//     terms one at a time from a ring ran each warp at ~200 cycles a term,
//     its branches in series: 2.1-2.3 ms.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TRSM_CPL = 4;         // columns of X a lane of the shared trsm
                                    // holds (one float4)
constexpr int TRSM_CW = 32 * TRSM_CPL;  // columns of X a block of it takes
constexpr int TRSM_Q = 16;          // rows of X a warp of it holds
constexpr int TRSM_CLUSTER = 8;     // neighbouring problems (blocks) a cluster
                                    // loads and stores together
constexpr int TRSM_LU = 8;          // its loads in flight a thread
constexpr int TRSM_ND = 32;         // terms of tril(A) a chunk of the streamed
                                    // narrow trsm (two in flight a thread)
constexpr int TRSM_NCY = 2;         // columns of X (warps) a block of it takes
constexpr int TRSM_MAX = 16 * TRSM_Q;  // the largest SM of either route
constexpr int GETRF_THREADS = 256;  // threads of the shared getrf

// problems a block of the register getrf takes: at most 512 threads of NB rows
template <int NB>
struct Reg {
  static constexpr int P = NB <= 16 ? 32 : 512 / NB;
};

// problems (P) and columns of X (CY) a block of the register trsm takes: 512
// threads up to NB = 32; 256 at NB = 64, which leaves a thread 255 registers
// and the lower triangle of A for 16 problems (133 KB) room in shared memory;
// NB = 0, the streamed solve: a warp of 32 problems a column, TRSM_NCY
// columns
template <int NB>
struct TrsmReg {
  static constexpr int P = NB == 0 || NB <= 32 ? 32 : 16;
  static constexpr int CY = NB == 0 ? TRSM_NCY : 16;
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
// Kernel 12's "shared" route (RECIP = false), and kernel 11 above the
// register buckets (RECIP = true): one block per problem, the matrix in
// shared memory [M][N].
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
// Kernel 12 at 65 <= min(M, N), max(M, N) <= 128 (the "tile" route; the
// first design, getrf_shared above, keeps every other size and ran 3.64 ms
// at 125 x 125, B = 4096, three shared accesses an update and two barriers
// a step): one block of GT_NW warps per problem, right-looking over a
// register tile.  Thread (warp w, lane x) holds rows w + GT_NW*q (q < GT_Q)
// and columns x + 32*c (c < GT_C) of the 128 x 128 padded matrix, so the
// shrinking trailing block stays spread over every warp and lane.  A group
// of rows or columns that the factorization has left behind is skipped: the
// pair of counts is block-uniform, and a switch picks a body compiled for it
// (getrf_tile_step), so no element of the update is tested; the dead and pad
// elements of a live group take their terms anyway (nobody reads them
// again).  Step k needs R_k (row k of U) and C_k (the multipliers of column
// k): both lie in the shared matrix s, which fills with LU as its rows and
// columns become final, so the update makes one shared load a row and one a
// column for its GT_Q * GT_C terms, O(n) shared traffic a step.  One
// barrier a step:
//   * C_{k+1} is made during step k.  The owner lanes of column k+1 put it in
//     pcol a step ahead (its values after k updates), so any thread can take
//     its step-k term and divide: threads 0.. take rows k+2.. (pivot
//     a[k+1,k+1] = pcol[k+1] - C_k[k+1] * R_k[k+1], the owner's own
//     arithmetic, so the bits agree);
//   * the owner warp of row k+1 writes R_{k+1} after its update;
//   * the owner lanes of column k+2 write pcol for step k+1 (two buffers).
// No location is written and read in the same step (tests/test_torch_packed
// emulates the schedule and checks that).  The load and store go through
// clusters of GT_CLUSTER neighbouring problems, as trsm_shared's (on the
// H100, clusters of 2 beat 4 and 8, whose blocks wait longer for the
// cluster's slowest, and no cluster at all, whose 4-byte loads each take a
// sector of their own).
// ---------------------------------------------------------------------------
constexpr int GT_NW = 16;            // warps of the tile getrf
constexpr int GT_Q = 128 / GT_NW;    // rows a thread holds: w + GT_NW * q
constexpr int GT_C = 4;              // columns a lane holds: x + 32 * c
constexpr int GT_LD = 129;           // row stride of the shared matrix (odd:
                                     // a column is read without conflicts)
constexpr int GT_MINB = 2;           // blocks an SM the registers must allow
constexpr int GT_CLUSTER = 2;        // neighbouring problems (blocks) a
                                     // cluster loads and stores together
constexpr int GT_LU = 8;             // its loads in flight a thread
constexpr int GT_MIN = 65;           // the tile route's min(M, N) ...
constexpr int GT_MAX = 128;          // ... and max(M, N)

// Step k's work on this thread's tile, with Q0 = (k + 1) / GT_NW row groups
// and C0 = (k + 1) / 32 column groups left behind: both block-uniform and
// fixed at compile time here (getrf_tile_rows picks the body), so nothing is
// tested per element of the update:
//   * the trailing update a[i,j] -= C_k[i] * R_k[j] (dead and pad elements
//     of a live group take garbage);
//   * R_{k+1} into `rownext` from its owner warp, whose row Q0 it is;
//   * column k + 2 for step k + 1 into `pc` from its owner lane: column
//     group C0, or C0 + 1 where k + 2 opens it.
template <int Q0, int C0>
__device__ __forceinline__ void getrf_tile_step(
    float (&r)[GT_Q][GT_C], const float (&u)[GT_C], const float* col,
    float* rownext, float* pc, int warp, int lane, int k, int m, int n,
    int kend) {
  float l[GT_Q];
#pragma unroll
  for (int q = Q0; q < GT_Q; ++q) l[q] = col[(warp + GT_NW * q) * GT_LD];
#pragma unroll
  for (int q = Q0; q < GT_Q; ++q) {
#pragma unroll
    for (int c = C0; c < GT_C; ++c)
      r[q][c] = __fsub_rn(r[q][c], __fmul_rn(l[q], u[c]));
  }
  if (warp == (k + 1) % GT_NW) {
#pragma unroll
    for (int c = C0; c < GT_C; ++c) {
      const int j = lane + 32 * c;
      if ((c > C0 || j > k) && j < n) rownext[j] = r[Q0][c];
    }
  }
  if (k + 2 < kend && lane == ((k + 2) & 31)) {
    constexpr int C1 = C0 + 1 < GT_C ? C0 + 1 : C0;
    const bool opens = ((k + 2) & 31) == 0;
#pragma unroll
    for (int q = Q0; q < GT_Q; ++q) {
      const int i = warp + GT_NW * q;
      if ((q > Q0 || i >= k + 2) && i < m) pc[i] = opens ? r[q][C1] : r[q][C0];
    }
  }
}

// the body of getrf_tile_step for qlo = (k + 1) / GT_NW
template <int Q0, int C0>
__device__ __forceinline__ void getrf_tile_rows(
    int qlo, float (&r)[GT_Q][GT_C], const float (&u)[GT_C], const float* col,
    float* rownext, float* pc, int warp, int lane, int k, int m, int n,
    int kend) {
  if constexpr (Q0 + 1 < GT_Q) {
    if (qlo > Q0) {
      getrf_tile_rows<Q0 + 1, C0>(qlo, r, u, col, rownext, pc, warp, lane, k,
                                  m, n, kend);
      return;
    }
  }
  getrf_tile_step<Q0, C0>(r, u, col, rownext, pc, warp, lane, k, m, n, kend);
}

__global__ void __cluster_dims__(GT_CLUSTER, 1, 1)
__launch_bounds__(GT_NW * 32, GT_MINB)
getrf_tile(const float* __restrict__ a, float* __restrict__ o, int m, int n,
           long long bp) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);  // [128][GT_LD]: A, then LU
  float* pcol = s + 128 * GT_LD;               // [2][128]: a column ahead
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x, b0 = b - rank;  // the cluster's problems
  constexpr int nt = GT_NW * 32;
  static_assert(nt >= 128, "a thread a row of the next column");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mn = m * n;
  // the load and store: GT_CLUSTER threads share an element of the
  // cluster's problems (neighbouring floats); block `rank` takes every
  // GT_CLUSTER-th element
  constexpr int stride = nt / GT_CLUSTER * GT_CLUSTER;
  const int first = tid / GT_CLUSTER * GT_CLUSTER + rank;
  const int p = tid % GT_CLUSTER;
  const long long bq = b0 + p;
  const bool on = bq < bp;

  // -- the load: the cluster's problems an element at a time, each into its
  // problem's block
  cluster.sync();  // every block of the cluster runs before any writes to it
  {
    float* s_p = cluster.map_shared_rank(s, p);
    for (int t0 = first; t0 < mn; t0 += GT_LU * stride) {
      float v[GT_LU];
#pragma unroll
      for (int u = 0; u < GT_LU; ++u) {
        const int t = t0 + u * stride;
        v[u] = on && t < mn ? a[(long long)t * bp + bq] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < GT_LU; ++u) {
        const int t = t0 + u * stride;
        if (on && t < mn) {
          const int i = t / n;
          s_p[i * GT_LD + t - i * n] = v[u];
        }
      }
    }
  }
  cluster.sync();

  // -- the factorization (a block past the last problem has none)
  if (b < bp) {
    float r[GT_Q][GT_C];
#pragma unroll
    for (int q = 0; q < GT_Q; ++q) {
      const int i = warp + GT_NW * q;
#pragma unroll
      for (int c = 0; c < GT_C; ++c) {
        const int j = lane + 32 * c;
        r[q][c] = i < m && j < n ? s[i * GT_LD + j] : 0.f;
      }
    }
    const int kend = min(n, m - 1);  // steps k < min(M, N) with k + 1 < M
    __syncthreads();  // every tile is read before C_0 overwrites column 0
    // C_0 (R_0 is A's row 0, in place) and column 1 for step 0
    for (int i = 1 + tid; i < m; i += nt) {
      s[i * GT_LD] = __fdiv_rn(s[i * GT_LD], s[0]);
      pcol[128 + i] = s[i * GT_LD + 1];
    }
    for (int k = 0; k < kend; ++k) {
      __syncthreads();  // R_k, C_k and column k + 1 ahead are in
      const float* rowk = s + k * GT_LD;
      // C_{k+1}: row k + 2 + tid's step-k term, then its multiplier
      if (const int i = k + 2 + tid; k + 1 < kend && i < m) {
        const float* pc = pcol + ((k + 1) & 1) * 128;
        const float u = rowk[k + 1];
        const float piv =
            __fsub_rn(pc[k + 1], __fmul_rn(s[(k + 1) * GT_LD + k], u));
        const float t = __fsub_rn(pc[i], __fmul_rn(s[i * GT_LD + k], u));
        s[i * GT_LD + k + 1] = __fdiv_rn(t, piv);
      }
      // the trailing update, R_{k+1} and column k + 2 ahead, over the
      // groups of rows and columns not left behind (a group is left behind
      // once all of it is <= k)
      float u[GT_C];
#pragma unroll
      for (int c = 0; c < GT_C; ++c) u[c] = rowk[lane + 32 * c];
      const int qlo = (k + 1) / GT_NW;
      float* rownext = s + (k + 1) * GT_LD;
      float* pc = pcol + (k & 1) * 128;
      switch ((k + 1) >> 5) {
        case 0:
          getrf_tile_rows<0, 0>(qlo, r, u, s + k, rownext, pc, warp, lane, k,
                                m, n, kend);
          break;
        case 1:
          getrf_tile_rows<0, 1>(qlo, r, u, s + k, rownext, pc, warp, lane, k,
                                m, n, kend);
          break;
        case 2:
          getrf_tile_rows<0, 2>(qlo, r, u, s + k, rownext, pc, warp, lane, k,
                                m, n, kend);
          break;
        default:
          getrf_tile_rows<0, 3>(qlo, r, u, s + k, rownext, pc, warp, lane, k,
                                m, n, kend);
      }
    }
  }
  cluster.sync();  // every LU is final in its block

  // -- the store: as the load, whole sectors again
  {
    const float* s_p = cluster.map_shared_rank(s, p);
    for (int t0 = first; t0 < mn; t0 += GT_LU * stride) {
      float v[GT_LU];
#pragma unroll
      for (int u = 0; u < GT_LU; ++u) {
        const int t = t0 + u * stride;
        const int i = t / n;
        v[u] = on && t < mn ? s_p[i * GT_LD + t - i * n] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < GT_LU; ++u) {
        const int t = t0 + u * stride;
        if (on && t < mn) o[(long long)t * bp + bq] = v[u];
      }
    }
  }
  // no block leaves while another reads its LU; the reads are done (their
  // values went to the stores), so the arrival orders no memory and no
  // block waits for its stores to drain
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The "narrow" route of kernels 13 and 14 (UNROLLED: kernel 13's
// arithmetic, else kernel 14's): one thread per (problem, column of X).  UP:
// the upper variant, the same solve with row i of A, B and X read at SM-1-i
// (and column i of A at SM-1-i), so triu(A) lands as the lower triangle.
//   * NB = 8 .. 64, SM <= NB (the register buckets, where narrow_bucket
//     sends a size): X's column in registers; the lower triangle of A for
//     the block's P problems is staged in shared memory [SM(SM+1)/2][P] once,
//     with whole-line loads.  Kernel 13 runs right-looking (row r's value
//     loses a[r,i] * x[i] at step i), kernel 14 left-looking (row i's sum
//     from 0 in r order): each row takes its terms in its plain version's
//     order.
//   * NB = 0 (trsm_narrow_stream): the triangle streamed from the pack.
// ---------------------------------------------------------------------------

// the row of the pack that the solve's row r reads: r, or SM-1-r upward
template <bool UP>
__device__ __forceinline__ int pack_row(int r, int sm) {
  return UP ? sm - 1 - r : r;
}

template <int NB, bool UP, bool UNROLLED>
__device__ __forceinline__ void trsm_reg_solve(const float* __restrict__ a,
                                               const float* __restrict__ bm,
                                               float* __restrict__ xo, int sm,
                                               int sn, long long bp,
                                               bool unit) {
  constexpr int P = TrsmReg<NB>::P;
  extern __shared__ float as[];
  const int x = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * P, b = b0 + x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int nthreads = P * blockDim.y;
  for (int t = threadIdx.y * P + x; t < sm * sm * P; t += nthreads) {
    const int e = t / P, q = t % P;
    const int r = pack_row<UP>(e / sm, sm), i = pack_row<UP>(e % sm, sm);
    if (i <= r && b0 + q < bp)
      as[(r * (r + 1) / 2 + i) * P + q] = a[(long long)e * bp + b0 + q];
  }
  __syncthreads();
  if (b >= bp || j >= sn) return;
  float xv[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i)
    xv[i] = i < sm ? bm[at(pack_row<UP>(i, sm), j, sn, bp, b)] : 0.f;
  if constexpr (UNROLLED) {
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
            xv[r] = __fsub_rn(
                xv[r], __fmul_rn(as[(r * (r + 1) / 2 + i) * P + x], xi));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i < sm) {
        const float* row = as + i * (i + 1) / 2 * P + x;  // row[r*P] = a[i,r]
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < i; ++r)
          s = __fadd_rn(s, __fmul_rn(row[r * P], xv[r]));
        float xi = __fsub_rn(xv[i], s);
        if (!unit) xi = __fdiv_rn(xi, row[i * P]);
        xv[i] = xi;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (i < sm) xo[at(pack_row<UP>(i, sm), j, sn, bp, b)] = xv[i];
}

// The streamed solve (the narrow route above 64).  Block g * ncg + c (ncg
// column groups, so the groups of one set of problems run side by side and
// meet its triangle in L1 or L2) holds 32 problems (lanes x) and TRSM_NCY
// columns (warps y).  B lands in this warp's xs
// [SM][32], and row i of it becomes x[i] once solved (shared memory: 500
// bytes a thread at 125, which caps an SM at about 13 warps, so the bytes in
// flight come from depth).  Row i of the solve reads a[i,0..i-1] (and a[i,i]
// where it divides): the lower triangle's (i, r) is row i*SM + r of the
// pack's [SM*SM, Bp] view, the upper's SM*SM-1 - (i*SM + r), so a row's
// terms are consecutive there and a warp's load is one 128-byte line.  They
// come in chunks of up to TRSM_ND terms of one row, into two banks of
// registers in turn: the next chunk's loads (and, with a row's last chunk,
// its diagonal) are in flight while the sum takes the current one, term by
// term, with no branch and no test inside a full chunk.  The sum, in the
// plain version's order:
//   kernel 14: s = 0, s += a[i,r] * x[r] for r ascending, x[i] = (b[i] - s)
//     / a[i,i];
//   kernel 13: v = b[i], v -= a[i,r] * x[r] for r ascending, x[i] = v *
//     (1 / a[i,i]).
// Unit diagonal: no division (no reciprocal), and a[i,i] is not read.
template <bool UP, bool UNROLLED>
__device__ __forceinline__ void trsm_narrow_stream(
    const float* __restrict__ a, const float* __restrict__ bm,
    float* __restrict__ xo, int sm, int sn, long long bp, bool unit) {
  extern __shared__ float xsh[];
  const int cy = blockDim.y, ncg = (sn + cy - 1) / cy;
  const long long b = (long long)(blockIdx.x / ncg) * 32 + threadIdx.x;
  const int j = (int)(blockIdx.x % ncg) * cy + threadIdx.y;
  if (b >= bp || j >= sn) return;  // no barrier below
  float* xs = xsh + threadIdx.y * sm * 32 + threadIdx.x;  // xs[r * 32]
  for (int i0 = 0; i0 < sm; i0 += TRSM_ND) {
    float v[TRSM_ND];
#pragma unroll
    for (int u = 0; u < TRSM_ND; ++u)
      if (i0 + u < sm) v[u] = bm[at(pack_row<UP>(i0 + u, sm), j, sn, bp, b)];
#pragma unroll
    for (int u = 0; u < TRSM_ND; ++u)
      if (i0 + u < sm) xs[(i0 + u) * 32] = v[u];
  }

  // a[i,r] of the solve at a0 + (i*SM + r) * step
  const long long step = UP ? -bp : bp;
  const float* a0 = a + (UP ? (long long)sm * sm - 1 : 0) * bp + b;
  // a chunk: row i's terms c0 .. c0 + len - 1, len = min(TRSM_ND, i - c0)
  // (row 0's one chunk has none); the next starts at c0 + TRSM_ND or row
  // i + 1
  auto next = [&](int& i, int& c0) {
    if (c0 + TRSM_ND < i) {
      c0 += TRSM_ND;
    } else {
      ++i;
      c0 = 0;
    }
  };
  auto fetch = [&](float (&bank)[TRSM_ND], float& d, int i, int c0) {
    const int len = min(TRSM_ND, i - c0);
    const float* p = a0 + ((long long)i * sm + c0) * step;
#pragma unroll
    for (int u = 0; u < TRSM_ND; ++u)
      if (u < len) bank[u] = __ldg(p + u * step);
    if (!unit && c0 + len == i) d = __ldg(p + len * step);  // a[i,i]
  };
  float s = UNROLLED ? xs[0] : 0.f;
  auto take = [&](const float (&bank)[TRSM_ND], float d, int i, int c0) {
    const int len = min(TRSM_ND, i - c0);
    const float* xr = xs + c0 * 32;
    if (len == TRSM_ND) {
#pragma unroll
      for (int u = 0; u < TRSM_ND; ++u) {
        const float t = __fmul_rn(bank[u], xr[u * 32]);
        s = UNROLLED ? __fsub_rn(s, t) : __fadd_rn(s, t);
      }
    } else {
#pragma unroll
      for (int u = 0; u < TRSM_ND; ++u) {
        if (u < len) {
          const float t = __fmul_rn(bank[u], xr[u * 32]);
          s = UNROLLED ? __fsub_rn(s, t) : __fadd_rn(s, t);
        }
      }
    }
    if (c0 + len == i) {  // the row's last chunk: x[i]
      float xi;
      if constexpr (UNROLLED) {
        xi = unit ? s : __fmul_rn(s, __frcp_rn(d));
      } else {
        xi = __fsub_rn(xs[i * 32], s);
        if (!unit) xi = __fdiv_rn(xi, d);
      }
      xs[i * 32] = xi;
      xo[at(pack_row<UP>(i, sm), j, sn, bp, b)] = xi;
      s = UNROLLED && i + 1 < sm ? xs[(i + 1) * 32] : 0.f;
    }
  };

  float bank0[TRSM_ND], bank1[TRSM_ND], d0 = 1.f, d1 = 1.f;
  int fi = 0, fc = 0, ti = 0, tc = 0;  // the chunks to fetch and to take
  fetch(bank0, d0, fi, fc);
  next(fi, fc);
  while (true) {
    if (fi < sm) fetch(bank1, d1, fi, fc);
    next(fi, fc);
    take(bank0, d0, ti, tc);
    next(ti, tc);
    if (ti >= sm) break;
    if (fi < sm) fetch(bank0, d0, fi, fc);
    next(fi, fc);
    take(bank1, d1, ti, tc);
    next(ti, tc);
    if (ti >= sm) break;
  }
}

template <int NB, bool UNROLLED>
__global__ void __launch_bounds__(TrsmReg<NB>::P * TrsmReg<NB>::CY)
trsm_reg(const float* __restrict__ a, const float* __restrict__ bm,
         float* __restrict__ xo, int sm, int sn, long long bp, bool unit) {
  if constexpr (NB == 0)
    trsm_narrow_stream<false, UNROLLED>(a, bm, xo, sm, sn, bp, unit);
  else
    trsm_reg_solve<NB, false, UNROLLED>(a, bm, xo, sm, sn, bp, unit);
}

template <int NB, bool UNROLLED>
__global__ void __launch_bounds__(TrsmReg<NB>::P * TrsmReg<NB>::CY)
trsm_reg_upper(const float* __restrict__ a, const float* __restrict__ bm,
               float* __restrict__ xo, int sm, int sn, long long bp,
               bool unit) {
  if constexpr (NB == 0)
    trsm_narrow_stream<true, UNROLLED>(a, bm, xo, sm, sn, bp, unit);
  else
    trsm_reg_solve<NB, true, UNROLLED>(a, bm, xo, sm, sn, bp, unit);
}

// ---------------------------------------------------------------------------
// The "chunk" route of kernel 14 (UNROLLED = false) and kernel 13 (UNROLLED =
// true): one block per (problem, chunk of up to TRSM_CW columns of X), NW
// warps.  tril(A) is packed by columns in shared memory; the
// chunk of B sits in shared memory [SM][cw], and row i of it is overwritten
// by x[i] once that is solved, which publishes it to the block.  The solve
// is right-looking over a register tile: warp w holds rows w + NW*q (q <
// TRSM_Q) of the chunk, each lane TRSM_CPL neighbouring columns, as running
// values v.  At step i every row r > i takes one term a[r,i] * x[i]; the
// terms are independent across rows and columns (up to 64 chains a thread),
// and rows are dealt to warps in turn, so the work stays even as the solve
// moves down.  The owner of row i + 1 takes its term first and solves it
// before its other rows, so one barrier a step publishes the next x.
// The blocks of a cluster (TRSM_CLUSTER neighbouring problems, the same
// chunk) load and store together: each block reads every TRSM_CLUSTER-th
// element of tril(A), B and X for all the cluster's problems, which lie in
// one 32-byte sector of the pack, and writes it to (or reads it from) its
// problem's block through distributed shared memory.
//   kernel 14: v starts at 0 and gathers s[r] = ((0 + a[r,0] x[0]) + a[r,1]
//     x[1]) + ..., the plain version's running sum; x[i] = (b[i] - s[i]) /
//     a[i,i];
//   kernel 13: v starts at b and loses a[r,i] * x[i] a step; x[i] = v[i] *
//     (1 / a[i,i]).
// Unit diagonal: no division (no reciprocal).
// UP (trsm_shared_upper): the loads and stores read element (R, I) of A, row
// R of B and write row R of X at R -> SM-1-R, I -> SM-1-I, so triu(A) takes
// the place of tril(A) and the solve runs from the last row up; the solve
// itself is the same code.  The sectors read and written are the lower
// variant's.
// ---------------------------------------------------------------------------

// offset of a[i,i] in tril(A) packed by columns (column i: rows i .. sm-1)
__device__ __forceinline__ int tri_col(int i, int sm) {
  return i * sm - i * (i - 1) / 2;
}

// this lane's TRSM_CPL (four) neighbouring columns of a row of the chunk
__device__ __forceinline__ void ld_cols(const float* p, float (&x)[TRSM_CPL]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}

__device__ __forceinline__ void st_cols(float* p, const float (&x)[TRSM_CPL]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// row r's running values less (kernel 13) or plus (kernel 14) a_ri * x
template <bool UNROLLED>
__device__ __forceinline__ void trsm_term(float (&v)[TRSM_CPL], float a_ri,
                                          const float (&x)[TRSM_CPL]) {
#pragma unroll
  for (int c = 0; c < TRSM_CPL; ++c)
    v[c] = UNROLLED ? __fsub_rn(v[c], __fmul_rn(a_ri, x[c]))
                    : __fadd_rn(v[c], __fmul_rn(a_ri, x[c]));
}

// x[i] of this lane's columns from row i's running values; stored over b[i]
// in the chunk (row `row` of xs).  Only the first `real` columns are X's:
// the padding past SN stays 0 without a division (0 / d would take the
// division's slow path).
template <bool UNROLLED>
__device__ __forceinline__ void trsm_solve_row(const float (&v)[TRSM_CPL],
                                               float* row, float d, bool unit,
                                               int real) {
  if (real <= 0) return;
  float x[TRSM_CPL];
  ld_cols(row, x);
#pragma unroll
  for (int c = 0; c < TRSM_CPL; ++c) {
    if (UNROLLED) {
      x[c] = unit || c >= real ? v[c] : __fmul_rn(v[c], __frcp_rn(d));
    } else {
      x[c] = __fsub_rn(x[c], v[c]);
      if (!unit && c < real) x[c] = __fdiv_rn(x[c], d);
    }
  }
  st_cols(row, x);
}

template <bool UNROLLED, int NW, bool UP>
__device__ __forceinline__ void trsm_shared_solve(
    const float* __restrict__ a, const float* __restrict__ bm,
    float* __restrict__ xo, int sm, int sn, int cw, long long bp, bool unit) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [sm][cw]: B, then X
  float* ta = xs + sm * cw;  // tril(A) packed by columns, NW * TRSM_Q pad
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x, b0 = b - rank;  // the cluster's problems
  const int tid = threadIdx.x, warp = tid >> 5, nt = NW * 32;
  const int j0 = blockIdx.y * TRSM_CW;
  const int c0 = (tid & 31) * TRSM_CPL;
  // columns of X this lane holds (0: none in this chunk; its loads then
  // read the first lane's columns and it stores nothing)
  const int real = min(TRSM_CPL, sn - j0 - c0);
  const int cl = c0 < cw ? c0 : 0;
  const int ntri = sm * (sm + 1) / 2;

  // -- the load: the cluster's TRSM_CLUSTER neighbouring problems share
  // each 32-byte sector of the pack, so block `rank` reads every
  // TRSM_CLUSTER-th element for all of them (TRSM_CLUSTER neighbouring
  // lanes, one sector) and puts each in its problem's block
  for (int t = tid; t < NW * TRSM_Q; t += nt) ta[ntri + t] = 0.f;
  cluster.sync();  // every block of the cluster runs before any writes to it
  {
    const int p = tid % TRSM_CLUSTER;
    float* ta_p = cluster.map_shared_rank(ta, p);
    float* xs_p = cluster.map_shared_rank(xs, p);
    const long long bq = b0 + p;
    const bool on = bq < bp;
    const int stride = nt / TRSM_CLUSTER * TRSM_CLUSTER;
    const int first = tid / TRSM_CLUSTER * TRSM_CLUSTER + rank;
    // TRSM_LU loads in flight a thread before their stores
    for (int t0 = first; t0 < sm * sm; t0 += TRSM_LU * stride) {
      float v[TRSM_LU];
#pragma unroll
      for (int u = 0; u < TRSM_LU; ++u) {
        const int t = t0 + u * stride;
        const int r = pack_row<UP>(t / sm, sm);
        const int i = pack_row<UP>(t - t / sm * sm, sm);
        v[u] = on && t < sm * sm && i <= r ? a[(long long)t * bp + bq] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < TRSM_LU; ++u) {
        const int t = t0 + u * stride;
        const int r = pack_row<UP>(t / sm, sm);
        const int i = pack_row<UP>(t - t / sm * sm, sm);
        if (on && t < sm * sm && i <= r) ta_p[tri_col(i, sm) + r - i] = v[u];
      }
    }
    for (int t0 = first; t0 < sm * cw; t0 += TRSM_LU * stride) {
      float v[TRSM_LU];
#pragma unroll
      for (int u = 0; u < TRSM_LU; ++u) {
        const int t = t0 + u * stride;
        const int r = t / cw, c = t - r * cw;
        v[u] = on && t < sm * cw && j0 + c < sn
                   ? bm[at(pack_row<UP>(r, sm), j0 + c, sn, bp, bq)]
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < TRSM_LU; ++u) {
        const int t = t0 + u * stride;
        if (on && t < sm * cw) xs_p[t] = v[u];
      }
    }
  }
  cluster.sync();

  // -- the solve (a block past the last problem has nothing to solve)
  float v[TRSM_Q][TRSM_CPL];
  if (b < bp) {
#pragma unroll
    for (int q = 0; q < TRSM_Q; ++q) {
      const int r = warp + NW * q;
#pragma unroll
      for (int c = 0; c < TRSM_CPL; ++c)
        v[q][c] = UNROLLED && r < sm ? xs[r * cw + cl + c] : 0.f;
    }
    if (warp == 0) trsm_solve_row<UNROLLED>(v[0], xs + c0, ta[0], unit, real);

    // step i = q * NW + wp publishes x[i], then every row takes its term:
    // rows already solved and rows past SM hold values nobody reads again,
    // so the terms are taken without a test (the pad past tril(A) keeps
    // their reads inside shared memory)
#pragma unroll
    for (int q = 0; q < TRSM_Q; ++q) {
      if (q * NW >= sm) break;
      for (int wp = 0; wp < NW; ++wp) {
        const int i = q * NW + wp;
        if (i >= sm) break;
        __syncthreads();  // x[i] is in row i of xs
        float x[TRSM_CPL];
        ld_cols(xs + i * cw + cl, x);
        const float* col = ta + tri_col(i, sm) - i;  // col[r] = a[r,i]
        // row i + 1 first: warp wp + 1 holds it as its row q, or (wp = NW
        // - 1) warp 0 as its row q + 1; its owner solves it at once
        {
          const int r = warp + NW * q;
          trsm_term<UNROLLED>(v[q], col[r], x);
          if (warp == wp + 1 && r < sm)
            trsm_solve_row<UNROLLED>(v[q], xs + r * cw + c0,
                                     ta[tri_col(r, sm)], unit, real);
        }
#pragma unroll
        for (int q2 = q + 1; q2 < TRSM_Q; ++q2) {
          const int r = warp + NW * q2;
          trsm_term<UNROLLED>(v[q2], col[r], x);
          if (q2 == q + 1 && warp == 0 && wp == NW - 1 && r < sm)
            trsm_solve_row<UNROLLED>(v[q2], xs + r * cw + c0,
                                     ta[tri_col(r, sm)], unit, real);
        }
      }
    }
  }
  cluster.sync();

  // -- the store: block `rank` writes every TRSM_CLUSTER-th element of X
  // for the cluster's problems, whole sectors again
  {
    const int p = tid % TRSM_CLUSTER;
    const float* xs_p = cluster.map_shared_rank(xs, p);
    const long long bq = b0 + p;
    const bool on = bq < bp;
    const int stride = nt / TRSM_CLUSTER * TRSM_CLUSTER;
    for (int t0 = tid / TRSM_CLUSTER * TRSM_CLUSTER + rank; t0 < sm * cw;
         t0 += TRSM_LU * stride) {
      float v[TRSM_LU];
#pragma unroll
      for (int u = 0; u < TRSM_LU; ++u) {
        const int t = t0 + u * stride;
        v[u] = on && t < sm * cw ? xs_p[t] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < TRSM_LU; ++u) {
        const int t = t0 + u * stride;
        const int r = t / cw, c = t - r * cw;
        if (on && t < sm * cw && j0 + c < sn)
          xo[at(pack_row<UP>(r, sm), j0 + c, sn, bp, bq)] = v[u];
      }
    }
  }
  cluster.sync();  // no block leaves while another reads its X
}

template <bool UNROLLED, int NW>
__global__ void __cluster_dims__(TRSM_CLUSTER, 1, 1)
__launch_bounds__(NW * 32, NW == 8 ? 2 : 1)
trsm_shared(const float* __restrict__ a, const float* __restrict__ bm,
            float* __restrict__ xo, int sm, int sn, int cw, long long bp,
            bool unit) {
  trsm_shared_solve<UNROLLED, NW, false>(a, bm, xo, sm, sn, cw, bp, unit);
}

template <bool UNROLLED, int NW>
__global__ void __cluster_dims__(TRSM_CLUSTER, 1, 1)
__launch_bounds__(NW * 32, NW == 8 ? 2 : 1)
trsm_shared_upper(const float* __restrict__ a, const float* __restrict__ bm,
                  float* __restrict__ xo, int sm, int sn, int cw, long long bp,
                  bool unit) {
  trsm_shared_solve<UNROLLED, NW, true>(a, bm, xo, sm, sn, cw, bp, unit);
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
                        int device, cudaStream_t st) {
  const size_t smem = (size_t)m * n * sizeof(float);
  if (smem > BLOCK_SMEM_MAX) return -2;
  auto kern = getrf_shared<RECIP>;
  prepare(kern, smem, device);
  kern<<<dim3((unsigned)bp), dim3(GETRF_THREADS), smem, st>>>(a, o, m, n, bp);
  return 0;
}

int launch_getrf_tile(const float* a, float* o, int m, int n, long long bp,
                      int device, cudaStream_t st) {
  if ((m < n ? m : n) < GT_MIN || (m > n ? m : n) > GT_MAX) return -2;
  const size_t smem = (128 * GT_LD + 2 * 128) * sizeof(float);
  static_assert(GT_C == 4 && GT_Q * GT_NW == 128, "the tile is 128 x 128");
  // whole clusters: blocks past the last problem load and factor nothing
  const long long gx = (bp + GT_CLUSTER - 1) / GT_CLUSTER * GT_CLUSTER;
  prepare(getrf_tile, smem, device);
  getrf_tile<<<dim3((unsigned)gx), dim3(GT_NW * 32), smem, st>>>(a, o, m, n,
                                                                bp);
  return 0;
}

template <int NB, bool UP, bool UNROLLED>
void launch_trsm_reg(const float* a, const float* b, float* x, int sm, int sn,
                     long long bp, bool unit, int device, cudaStream_t st) {
  constexpr int P = TrsmReg<NB>::P, CY = TrsmReg<NB>::CY;
  const int cy = sn < CY ? sn : CY;
  const size_t smem = (size_t)sm * (sm + 1) / 2 * P * sizeof(float);
  auto kern = UP ? trsm_reg_upper<NB, UNROLLED> : trsm_reg<NB, UNROLLED>;
  prepare(kern, smem, device);
  kern<<<dim3((unsigned)((bp + P - 1) / P), (unsigned)((sn + cy - 1) / cy)),
         dim3(P, cy), smem, st>>>(a, b, x, sm, sn, bp, unit);
}

// Which solve the narrow route runs: the register buckets stage tril(A) once
// for a block's 16 columns but run few threads at few columns (and 16
// problems a block at NB = 64), the streamed solve reads A once a column.
// On the H100 (B = 4096 and 131072) the buckets won at SM <= 32 from 4
// columns (16/16: 0.18 ms against 0.64) and at 33..48 from 16; the streamed
// solve everywhere else (16/1: 0.056 against 0.132; 64/1: 0.43 against 27).
bool narrow_bucket(int sm, int sn) {
  return sm <= 32 ? sn >= 4 : sm <= 48 ? sn >= 16 : false;
}

// the narrow route: the register buckets or the streamed solve
template <bool UNROLLED, bool UP>
int launch_trsm_narrow(const float* a, const float* b, float* x, int sm,
                       int sn, long long bp, bool unit, int device,
                       cudaStream_t st) {
  if (sm > TRSM_MAX) return -2;
  switch (narrow_bucket(sm, sn) ? bucket(sm) : 0) {
    case 8:
      launch_trsm_reg<8, UP, UNROLLED>(a, b, x, sm, sn, bp, unit, device, st);
      return 0;
    case 16:
      launch_trsm_reg<16, UP, UNROLLED>(a, b, x, sm, sn, bp, unit, device, st);
      return 0;
    case 32:
      launch_trsm_reg<32, UP, UNROLLED>(a, b, x, sm, sn, bp, unit, device, st);
      return 0;
    case 64:
      launch_trsm_reg<64, UP, UNROLLED>(a, b, x, sm, sn, bp, unit, device, st);
      return 0;
  }
  const int cy = sn < TRSM_NCY ? sn : TRSM_NCY;
  const size_t smem = (size_t)cy * sm * 32 * sizeof(float);
  auto kern = UP ? trsm_reg_upper<0, UNROLLED> : trsm_reg<0, UNROLLED>;
  prepare(kern, smem, device);
  const long long blocks = (bp + 31) / 32 * ((sn + cy - 1) / cy);
  kern<<<dim3((unsigned)blocks), dim3(32, cy), smem, st>>>(a, b, x, sm, sn,
                                                           bp, unit);
  return 0;
}

template <bool UNROLLED, bool UP>
int launch_trsm_shared(const float* a, const float* b, float* x, int sm, int sn,
                       long long bp, bool unit, int device, cudaStream_t st) {
  // a chunk of up to TRSM_CW columns, TRSM_CPL a lane
  const int cw = sn >= TRSM_CW ? TRSM_CW
                               : (sn + TRSM_CPL - 1) / TRSM_CPL * TRSM_CPL;
  const int nw = sm <= 8 * TRSM_Q ? 8 : 16;
  const size_t smem = ((size_t)sm * (sm + 1) / 2 + (size_t)nw * TRSM_Q +
                       (size_t)sm * cw) * sizeof(float);
  if (smem > BLOCK_SMEM_MAX || sm > TRSM_MAX) return -2;
  // whole clusters: blocks past the last problem load and solve nothing
  const long long gx = (bp + TRSM_CLUSTER - 1) / TRSM_CLUSTER * TRSM_CLUSTER;
  const dim3 grid((unsigned)gx, (unsigned)((sn + TRSM_CW - 1) / TRSM_CW));
  auto kern = UP ? (nw == 8 ? trsm_shared_upper<UNROLLED, 8>
                            : trsm_shared_upper<UNROLLED, 16>)
                 : (nw == 8 ? trsm_shared<UNROLLED, 8>
                            : trsm_shared<UNROLLED, 16>);
  prepare(kern, smem, device);
  kern<<<grid, dim3(nw * 32), smem, st>>>(a, b, x, sm, sn, cw, bp, unit);
  return 0;
}

// route 0 ("chunk"): trsm_shared; route 1 ("narrow"): trsm_reg
template <bool UNROLLED, bool UP>
int trsm_entry(const float* a, const float* b, float* x, int sm, int sn,
               long long bp, int unit, int route, int device, void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  if (route == 1 ? launch_trsm_narrow<UNROLLED, UP>(a, b, x, sm, sn, bp,
                                                    unit != 0, device, st)
                 : launch_trsm_shared<UNROLLED, UP>(a, b, x, sm, sn, bp,
                                                    unit != 0, device, st))
    return -2;
  return (int)cudaGetLastError();
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
      if (launch_getrf_shared<true>(a, o, m, n, bp, device, st)) return -2;
  }
  return (int)cudaGetLastError();
}

// route 0 ("shared"): getrf_shared, any size whose matrix fits a block's
// shared memory; route 1 ("tile"): getrf_tile, -2 outside 65 <= min(M, N),
// max(M, N) <= 128
extern "C" int xsmm_getrf_loop(const float* a, float* o, int m, int n,
                               long long bp, int route, int device,
                               void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  if (route == 1 ? launch_getrf_tile(a, o, m, n, bp, device, st)
                 : launch_getrf_shared<false>(a, o, m, n, bp, device, st))
    return -2;
  return (int)cudaGetLastError();
}

// tril(A) X = B (unit diagonal if `unit`); the _upper entries: triu(A) X = B.
// `route` 0 ("chunk"): the block a problem (trsm_shared), any SM <= 256 whose
// chunk fits a block's shared memory; 1 ("narrow"): a thread a (problem,
// column) (trsm_reg), SM <= 256; -2 outside those sizes
extern "C" int xsmm_trsm_unrolled(const float* a, const float* b, float* x,
                                  int sm, int sn, long long bp, int unit,
                                  int route, int device, void* stream) {
  return trsm_entry<true, false>(a, b, x, sm, sn, bp, unit, route, device,
                                 stream);
}

extern "C" int xsmm_trsm_unrolled_upper(const float* a, const float* b,
                                        float* x, int sm, int sn, long long bp,
                                        int unit, int route, int device,
                                        void* stream) {
  return trsm_entry<true, true>(a, b, x, sm, sn, bp, unit, route, device,
                                stream);
}

extern "C" int xsmm_trsm_loop(const float* a, const float* b, float* x, int sm,
                              int sn, long long bp, int unit, int route,
                              int device, void* stream) {
  return trsm_entry<false, false>(a, b, x, sm, sn, bp, unit, route, device,
                                  stream);
}

extern "C" int xsmm_trsm_loop_upper(const float* a, const float* b, float* x,
                                    int sm, int sn, long long bp, int unit,
                                    int route, int device, void* stream) {
  return trsm_entry<false, true>(a, b, x, sm, sn, bp, unit, route, device,
                                 stream);
}
