// The RNN sequence kernels (LSTM, GRU, simple RNN), forward and backward: the
// six Hopper kernels behind xsmm_tpu_torch/dnn/rnn_seq.py, built for sm_90a
// with a plain C interface (loaded through ctypes by ops/cuda_build.py).
//
// Entry points and the TPU kernels they replace:
//   xsmm_lstm_seq <- xsmm_tpu/dnn/rnn_seq.py:112 _lstm_kernel (lstm_seq)
//   xsmm_gru_seq  <- xsmm_tpu/dnn/rnn_seq.py:271 _gru_kernel  (gru_seq)
//   xsmm_rnn_seq  <- xsmm_tpu/dnn/rnn_seq.py:451 _rnn_kernel  (rnn_seq)
//   xsmm_rnn_seq_fits: the envelope of the three (dnn/rnn_seq.seq_kernel_ok)
//   xsmm_lstm_seq_bwd <- xsmm_tpu/dnn/rnn_seq.py:185 _lstm_bwd_kernel
//   xsmm_gru_seq_bwd  <- xsmm_tpu/dnn/rnn_seq.py:335 _gru_bwd_kernel
//   xsmm_rnn_seq_bwd  <- xsmm_tpu/dnn/rnn_seq.py:407 _rnn_bwd_kernel
//   xsmm_rnn_seq_bwd_fits: the envelope of the backward three
//   (dnn/rnn_seq.seq_bwd_kernel_ok); their design is set out above seq_bwd.
//
// Backward bound on an H100 SXM at N 128, K 512, T 32, each input read once
// and each output written once: LSTM dhs and five residuals 50 MB + dz 33.5
// MB (f32) + R 4.2 MB, ~26 us of bytes against dz @ R^T's 2*T*N*4K*K = 8.6
// GFLOP, 0.128 ms at the FP32 rate (operations); with bf16 R and dz, ~21 us
// of bytes.  GRU 0.096 ms, RNN 0.032 ms (f32, operations).  Like the
// forward, the product runs on FFMA and T barriers add a latency floor.
//
// Each computes T sequential steps of z = zx[t] + h @ R and the gate math of
// its cell, with zx = x @ W + b precomputed for all steps by the caller:
//   zx [T, N, G*K] f32, R [K, G*K] f32 or bf16, h0 (c0) [N, K] f32
//   -> hs [T, N, K] f32, h_T (c_T) [N, K] f32; in the train form also the
//   residuals (LSTM cs, i, g, f, o; GRU r, z, g, (h@R)_g), each [T, N, K].
// G = 4 gates (i, g, f, o) for the LSTM, 3 (r, z, g) for the GRU, 1 for the
// simple RNN (act = relu, sigmoid or tanh).  f32 R: full f32 FFMA, no TF32.
// bf16 R: h is rounded to bf16 (round to nearest even) before the product,
// as the JAX kernel's h.astype(r.dtype); a product of two bf16 values is
// exact in f32, so FFMA on the rounded operands sums in f32 as the MXU's
// preferred_element_type=f32.  Each sum is one FFMA chain in k order, which
// the plain version's k-order addcmul reproduces exactly for bf16 operands.
// Gate math in f32: sigmoid = 1/(1+expf(-x)), tanhf, and every product and
// sum of the gate math rounded on its own, as torch's separate ops round
// them; built without --use_fast_math.
//
// Design: one persistent cooperative kernel over all T steps.  The TPU runs
// the T grid in order on one core with R resident in VMEM and h, c in
// scratch; here blocks run in parallel and only h is sequential (step t
// needs all of h_{t-1} for every output column):
//   * Columns.  A block owns 16 column groups of 4 gate columns: for the LSTM
//     the 4 gates of one hidden unit j (columns j, K+j, 2K+j, 3K+j), for the
//     GRU the 3 of one unit (and a zero column), for the RNN 4 consecutive
//     units.  The gate epilogue is local to a thread; GRU's r * (h@R)_g
//     needs nothing from other blocks.
//   * R.  The block's R slice, K x 64 columns in R's dtype, is staged in
//     shared memory once and stays there for all T steps (the counterpart of
//     the TPU's resident R): 128 KB in f32, 64 KB in bf16 at K = 512.
//   * Rows.  A block owns one or more passes of 32 rows; the host picks the
//     fewest passes that keep the grid co-resident.  A thread owns 4 rows x
//     one column group: 16 f32 accumulators, one float4 of h and one vector
//     of 4 R values from shared memory per k.
//   * h exchange.  Each step every block writes its h columns into a
//     double-buffered [2, N, Kp] f32 buffer in device memory (Kp = K rounded
//     up to 4; 512 KB at N 128, K 512, held in L2), then a grid barrier,
//     then every block stages the rows of h_{t-1} it needs, 64 k at a time,
//     transposed into shared memory, prefetching the next chunk into
//     registers during the product.  The buffer is read with ld.global.cg
//     (L2, never the non-coherent or L1 path) and written with st.global.cg,
//     so no block reads a stale h.
//   * State.  c (LSTM) lives in c_T, read and written only by the thread
//     that owns it; it leaves the SM as c_T and, in the train form, as cs.
//   * Barrier.  Hand-written: a monotone arrival counter in device memory,
//     zeroed by the entry point before the launch; block b arrives after
//     __syncthreads and __threadfence, thread 0 spins on an acquire load
//     until the count reaches (t+1) x gridDim.x, fences, __syncthreads.
//     The launch is cudaLaunchCooperativeKernel, with the grid sized from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, so a
//     grid that cannot be co-resident is refused before any launch (-2)
//     and never hangs.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32, 989 TFLOP/s bf16 on the
// tensor cores), each input read once and each output written once, at
// N = 128, K = 512, T = 32:
//   LSTM: zx 33.5 MB + R 4.2 (f32) / 2.1 (bf16) MB + hs 8.4 MB: ~14 us of
//         bytes; h@R is 2*T*N*K*4K = 8.6 GFLOP: 0.128 ms at the FP32 rate
//         (operations), 8.7 us at the bf16 rate (bytes then bound: 13 us).
//         The train form writes 42 MB more (five [T,N,K] streams).
//   GRU:  0.096 ms (f32, operations), ~10.5 us (bf16, bytes).
//   RNN:  0.032 ms (f32, operations), ~5.2 us (bf16, bytes).
// This kernel runs the product on FFMA (no tensor cores), so the FP32 rate
// bounds it in both dtypes; and T sequential steps add a latency floor of
// T x (barrier + one step) that neither bound counts.  What holds it, as
// measured with clock64() stamps at N 128, K 512, T 32: the product, ~12 us a
// step of ~15, where a thread's 4 x 4 tile takes two 128-bit shared-memory
// loads per 16 FFMA (32 wavefronts per k on an SM against 16 FFMA cycles a
// scheduler); the grid barrier takes ~1.5 us a step, the epilogue ~1 us.
// mma.sync / wgmma for the bf16 cells, and a larger register tile, are the
// ways up.
//
// Envelope: the R slice and the 8 KB h chunk must fit a block's shared
// memory (K <= 832 with f32 R, K <= 1728 with bf16 R), and the column blocks
// (ceil(K/16), RNN ceil(K/64)) must be co-resident.  Any N and K inside it,
// and any T >= 1, work: rows >= N, units >= K and k >= K are masked.  The
// backward's: its R^T slice and 16 KB dz chunk (LSTM K <= 832 f32, <= 1664
// bf16; GRU K <= 1109 f32), and ceil(K/16) co-resident column blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SHARED_MAX = 232448;  // bytes of shared memory a block may have
constexpr int THREADS = 128;
constexpr int CG = 16;             // column groups a block owns
constexpr int RM = 4;              // rows a thread owns in a pass
constexpr int ROWS = THREADS / CG * RM;  // 32 rows a pass
constexpr int COLS = CG * 4;       // gate columns a block owns
constexpr int KT = 64;             // k staged per chunk of h
constexpr int H_SMEM = KT * ROWS * 4;    // 8 KB: hT[KT][ROWS] f32
constexpr int SQ = THREADS / ROWS;       // staging threads a row
constexpr int QPT = KT / 4 / SQ;         // float4 quads a thread stages a chunk
constexpr int RB = 32;                   // R loads a thread keeps in flight

enum Cell { LSTM = 0, GRU = 1, RNN = 2 };

template <int CELL>
struct CellTraits {
  static constexpr int G = CELL == LSTM ? 4 : CELL == GRU ? 3 : 1;
  static constexpr int UNITS = CELL == RNN ? CG * 4 : CG;  // units a block owns
};

struct Params {
  const float* zx;     // [T, N, G*K]
  const void* r;       // [K, G*K], float or bf16
  const float* h0;     // [N, K]
  const float* c0;     // [N, K] (LSTM)
  float* hs;           // [T, N, K]
  float* ht;           // [N, K]
  float* ct;           // [N, K] (LSTM): the running c, c_T at the end
  float* res[5];       // the train form's residuals, each [T, N, K]
  float* hbuf;         // [2, N, kp]
  unsigned* bar;       // arrival counter, zero at launch
  int t, n, k, kp, kr; // kp: K rounded up to 4; kr: K rounded up to KT
  int cb, passes;      // column blocks; 32-row passes a block
  int act;             // RNN: 0 relu, 1 sigmoid, 2 tanh
  int h0_vec;          // h0's rows are 16-byte aligned
};

// four consecutive R values of one k row, as f32
__device__ __forceinline__ float4 load_r4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_r4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <typename RT>
__device__ __forceinline__ float to_r(float v) {
  if constexpr (sizeof(RT) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

template <typename RT>
__device__ __forceinline__ RT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// as torch.sigmoid on the card computes it: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// Element e of a block's R slice (row k = e / COLS): its index in the
// shared-memory slice, and in *src its index in R, or -1 for a zero (k >= K,
// a unit >= K, the GRU's fourth column).
template <int CELL>
__device__ __forceinline__ int r_slot(int e, int j0, int kk, size_t gk, long long* src) {
  const int k = e / COLS, q = e % COLS;
  int g, c, j;
  if (CELL == RNN) {
    g = q / 4; c = q % 4; j = j0 + q;       // 4 consecutive units a group
  } else {
    c = q / CG; g = q % CG; j = j0 + g;     // gate c of unit j
  }
  const bool live = k < kk && j < kk && (CELL == RNN || c < CellTraits<CELL>::G);
  *src = live ? (long long)k * (long long)gk + (CELL == RNN ? j : (long long)c * kk + j) : -1;
  return k * COLS + g * 4 + c;
}

// Grid barrier number s (0-based): every block arrives once; returns when all
// gridDim.x blocks have arrived s + 1 times.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned v;
    for (long long spin = 0;; ++spin) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
      if (v >= target) break;
      // a block that never arrives (it cannot: the launch is cooperative)
      // would hang the card; after seconds of waiting, fail the launch
      if (spin > (1LL << 28)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Four h values h[n][k..k+3], read at L2; zeros where n >= N or k >= K.  The
// lanes k+i >= K of an aligned load are zeroed where they are stored, not
// here: a select on the loaded value would wait for the load, and the load
// is a prefetch for the next chunk.
__device__ __forceinline__ float4 load_h4(const float* src, int stride, bool vec,
                                          int n, int k, int nn, int kk) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n < nn && k < kk) {
    const float* p = src + (size_t)n * stride + k;
    if (vec) {
      v = __ldcg(reinterpret_cast<const float4*>(p));
    } else {
      v.x = __ldcg(p);
      if (k + 1 < kk) v.y = __ldcg(p + 1);
      if (k + 2 < kk) v.z = __ldcg(p + 2);
      if (k + 3 < kk) v.w = __ldcg(p + 3);
    }
  }
  return v;
}

// RM consecutive f32 values of shared memory (16- or 8-byte aligned)
template <int M>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[M]) {
  if constexpr (M == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    static_assert(M == 2, "RM is 2 or 4");
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

template <int CELL, typename RT, bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1) seq_fwd(Params p) {
  constexpr int G = CellTraits<CELL>::G;
  constexpr int UNITS = CellTraits<CELL>::UNITS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hT = reinterpret_cast<float*>(smem);            // [KT][ROWS]
  RT* rs = reinterpret_cast<RT*>(smem + H_SMEM);          // [kr][COLS]

  const int tid = threadIdx.x;
  const int cg = tid % CG, rg = tid / CG;                 // compute mapping
  const int sr = tid % ROWS, sq = tid / ROWS;             // staging mapping
  const int cbi = blockIdx.x % p.cb, rbi = blockIdx.x / p.cb;
  const int j0 = cbi * UNITS;
  const int nn = p.n, kk = p.k;
  const size_t gk = (size_t)G * kk;
  const RT* rsrc = static_cast<const RT*>(p.r);

  // -- the block's R slice, once: rs[k][cg*4 + c], RB loads in flight --------
  const int total = p.kr * COLS;
  for (int e0 = tid; e0 < total; e0 += THREADS * RB) {
    RT v[RB];
    int dst[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int e = e0 + u * THREADS;
      long long src = -1;
      dst[u] = e < total ? r_slot<CELL>(e, j0, kk, gk, &src) : -1;
      v[u] = src >= 0 ? rsrc[src] : from_f<RT>(0.f);
    }
#pragma unroll
    for (int u = 0; u < RB; ++u)
      if (dst[u] >= 0) rs[dst[u]] = v[u];
  }

  const int row0 = rbi * p.passes * ROWS;
  for (int t = 0; t < p.t; ++t) {
    const float* hin = t == 0 ? p.h0 : p.hbuf + (size_t)((t - 1) & 1) * nn * p.kp;
    const int hstride = t == 0 ? kk : p.kp;
    const bool hvec = t == 0 ? p.h0_vec != 0 : true;
    float* hout = p.hbuf + (size_t)(t & 1) * nn * p.kp;
    const bool last = t + 1 == p.t;

    for (int ps = 0; ps < p.passes; ++ps) {
      const int n0 = row0 + ps * ROWS;
      if (n0 >= nn) break;  // block-uniform

      // the epilogue's operands, loaded before the product so that their
      // latency hides behind it: zx of the thread's columns, and c (LSTM) or
      // h_{t-1} (GRU) of its units
      float zv[RM][4], sv[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int n = n0 + rg * RM + r;
        const float* zrow = p.zx + ((size_t)t * nn + n) * gk;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = CELL == RNN ? j0 + cg * 4 + c : j0 + cg;
          const bool live = n < nn && j < kk && (CELL == RNN || c < G);
          zv[r][c] = live ? zrow[CELL == RNN ? j : c * kk + j] : 0.f;
        }
        const int j = j0 + cg;
        const size_t e = (size_t)n * kk + j;
        sv[r] = 0.f;
        if (CELL == LSTM && n < nn && j < kk) sv[r] = t == 0 ? p.c0[e] : p.ct[e];
        if (CELL == GRU && n < nn && j < kk) sv[r] = __ldcg(hin + (size_t)n * hstride + j);
      }

      float acc[RM][4];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

      // staging: thread (sr, sq) loads quads sq, sq+SQ, ... of row sr
      float4 pre[QPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
        pre[i] = load_h4(hin, hstride, hvec, n0 + sr, 4 * (sq + SQ * i), nn, kk);

      for (int k0 = 0; k0 < p.kr; k0 += KT) {
        __syncthreads();  // the previous chunk is consumed
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const int q = 4 * (sq + SQ * i), kq = k0 + q;   // k in the chunk, in h
          hT[(q + 0) * ROWS + sr] = to_r<RT>(pre[i].x);
          hT[(q + 1) * ROWS + sr] = kq + 1 < kk ? to_r<RT>(pre[i].y) : 0.f;
          hT[(q + 2) * ROWS + sr] = kq + 2 < kk ? to_r<RT>(pre[i].z) : 0.f;
          hT[(q + 3) * ROWS + sr] = kq + 3 < kk ? to_r<RT>(pre[i].w) : 0.f;
        }
        __syncthreads();
        if (k0 + KT < p.kr) {
#pragma unroll
          for (int i = 0; i < QPT; ++i)
            pre[i] = load_h4(hin, hstride, hvec, n0 + sr, k0 + KT + 4 * (sq + SQ * i), nn, kk);
        }
        const RT* rrow = rs + (size_t)k0 * COLS + cg * 4;
        const float* hrow = hT + rg * RM;
#pragma unroll 8
        for (int k = 0; k < KT; ++k) {
          float hv[RM];
          load_rows(hrow + k * ROWS, hv);
          const float4 rv = load_r4(rrow + (size_t)k * COLS);
          const float r4[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(hv[r], r4[c], acc[r][c]);
        }
      }

      // -- the gate epilogue: the thread's 4 rows x its column group.  Every
      // product and sum is rounded on its own (no FMA contraction), as the
      // plain versions' separate torch ops round them.
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int n = n0 + rg * RM + r;
        if (n >= nn) continue;
        const size_t srow = ((size_t)t * nn + n) * kk;   // row n of step t, [T,N,K]
        if (CELL == RNN) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + cg * 4 + c;
            if (j >= kk) continue;
            const float z = __fadd_rn(zv[r][c], acc[r][c]);
            const float h2 = p.act == 0 ? (z > 0.f ? z : 0.f)
                             : p.act == 1 ? sigmoid(z) : tanhf(z);
            __stcg(hout + (size_t)n * p.kp + j, h2);
            p.hs[srow + j] = h2;
            if (last) p.ht[(size_t)n * kk + j] = h2;
          }
        } else {
          const int j = j0 + cg;
          if (j >= kk) continue;
          float h2;
          if (CELL == LSTM) {
            const float i = sigmoid(__fadd_rn(zv[r][0], acc[r][0]));
            const float g = tanhf(__fadd_rn(zv[r][1], acc[r][1]));
            const float f = sigmoid(__fadd_rn(zv[r][2], acc[r][2]));
            const float o = sigmoid(__fadd_rn(zv[r][3], acc[r][3]));
            const float c2 = __fadd_rn(__fmul_rn(f, sv[r]), __fmul_rn(i, g));
            h2 = __fmul_rn(o, tanhf(c2));
            p.ct[(size_t)n * kk + j] = c2;
            if (TRAIN) {
              p.res[0][srow + j] = c2;
              p.res[1][srow + j] = i;
              p.res[2][srow + j] = g;
              p.res[3][srow + j] = f;
              p.res[4][srow + j] = o;
            }
          } else {
            const float ri = sigmoid(__fadd_rn(zv[r][0], acc[r][0]));
            const float zi = sigmoid(__fadd_rn(zv[r][1], acc[r][1]));
            const float zrg = acc[r][2];
            const float gi = tanhf(__fadd_rn(zv[r][2], __fmul_rn(ri, zrg)));
            h2 = __fadd_rn(__fmul_rn(__fsub_rn(1.f, zi), gi), __fmul_rn(zi, sv[r]));
            if (TRAIN) {
              p.res[0][srow + j] = ri;
              p.res[1][srow + j] = zi;
              p.res[2][srow + j] = gi;
              p.res[3][srow + j] = zrg;
            }
          }
          __stcg(hout + (size_t)n * p.kp + j, h2);
          p.hs[srow + j] = h2;
          if (last) p.ht[(size_t)n * kk + j] = h2;
        }
      }
    }
    if (!last) grid_barrier(p.bar, (unsigned)(t + 1) * gridDim.x);
  }
}

// ---------------------------------------------------------------------------
// The backward kernels: the reverse scan t = T-1 .. 0 of the cell's gradient.
//
// Per step: dh = dhs[t] + dh_carry (and dc for the LSTM); the gate-gradient
// math, local to the (row, unit) it belongs to; dz[t] written out; db summed;
// then dh_prev = dz_t @ R^T, which needs all G*K columns of dz_t for every
// unit, so it is the only part that crosses blocks.
//   * Units.  A block owns BU = 16 hidden units j (dh, dc and the G dz columns
//     j, K+j, ... of each) and one or more 32-row passes.
//   * R^T.  The block's slice is columns j0 .. j0+15 of R^T [G*K, K], every
//     row: gkr x 16 values in R's dtype, in shared memory for all T steps
//     (128 KB in f32, 64 KB in bf16 for the LSTM at K = 512).
//   * Exchange.  The epilogue writes the product's operand (dz rounded to R's
//     dtype; for the GRU [dri, dzi, dgi*ri]) into a double-buffered
//     [2, N, gkp] buffer with st.global.cg; after the grid barrier every block
//     stages the rows of its pass, BKT columns at a time, transposed into
//     shared memory, reading with ld.global.cg (L2, never the non-coherent
//     path), and prefetching the next chunk into registers.  A warp loads
//     whole lines (4 rows x 8 quads), not a row a lane: the staging costs
//     what its requests cost, and a lane a row made the step 1.5-2x longer
//     on the H100 (dz_at keeps the transposing stores conflict-free).  A
//     buffer of its own rather than dz: the GRU's operand is not one output
//     array, and dz may be emitted in another dtype than R's.
//   * Product.  Warp w sums the chunk positions [32w, 32w + 32) of every chunk
//     for a 4-row x 4-unit tile (16 f32 sums, one float4 of dz and one vector
//     of 4 R^T values a k); the four warps' sums are then added in warp order
//     through shared memory.  With bf16 R each sum is one FMA chain of exact
//     products, which the plain version's grouped addcmul reproduces.
//   * Carries.  dc (LSTM) and dh * zi (GRU) are kept in device memory by the
//     thread that owns the (row, unit); the LSTM's running dc is dc0's buffer.
//   * db.  Each thread sums its rows over all steps; at t = 0 the block sums
//     its threads in a fixed order into a row-block partial, and after the
//     last barrier the blocks of row block 0 add the partials in row-block
//     order: no atomics, the same bits on every launch.
//   * T barriers: the last product (dh0) needs all of dz_0.
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 128;
constexpr int BU = 16;                        // hidden units a block owns
constexpr int BROWS = 32;                     // rows a pass
constexpr int BKT = 128;                      // contraction staged per chunk
constexpr int KGROUPS = BWD_THREADS / 32;     // warp w sums quarter w of a chunk
constexpr int KPW = BKT / KGROUPS;            // 32 chunk positions a warp
constexpr int B_SMEM = BKT * BROWS * 4;       // 16 KB: dzT[BKT][BROWS] f32
constexpr int BQPT = BKT / 4 * BROWS / BWD_THREADS;  // quads a thread stages a chunk
constexpr int ERM = BROWS * BU / BWD_THREADS; // rows of a thread's epilogue
constexpr int BRB = 32;                       // R^T loads a thread keeps in flight
static_assert(KGROUPS * BROWS * BU * 4 <= B_SMEM, "the partial sums reuse dzT");
static_assert(BROWS == 32 && BU == 16 && ERM * BWD_THREADS == BROWS * BU && KPW % 8 == 0,
              "a warp's 4 x 4 tiles cover the block's 32 rows x 16 units");
static_assert(KGROUPS * BQPT == BROWS / 4 * (BKT / 32), "the staging tiles cover a chunk");

// The place of (chunk position kq, row) in dzT: the 4-row group is XORed
// with kq / 4, so that a warp storing 4 rows x 32 positions hits all 32
// banks, while the product's float4 of 4 rows at one kq stays whole.
__device__ __forceinline__ int dz_at(int kq, int row) {
  return kq * BROWS + ((((row >> 2) ^ (kq >> 2)) & 7) << 2) + (row & 3);
}

struct BwdParams {
  const float* dhs;     // [T, N, K]
  const float* res[5];  // residuals [T, N, K]: LSTM i, g, f, o, cs; GRU ri, zi,
                        // gi, zr_g, hs; RNN hs
  const float* s0;      // [N, K]: the state before step 0 (LSTM c0, GRU h0)
  const float* dht;     // [N, K]
  const float* dct;     // [N, K] (LSTM)
  const void* rt;       // [G*K, K], float or bf16: R^T
  void* dz;             // [T, N, G*K], f32 or bf16 (dz_bf16)
  void* dgiri;          // [T, N, K] (GRU), dz's dtype
  float* dh0;           // [N, K]
  float* carry;         // [N, K]: LSTM the running dc (dc0 at the end); GRU dh*zi
  float* db;            // [G*K]
  float* dbp;           // [row blocks, G*K]: the row blocks' partial sums of db
  void* xbuf;           // [2, N, gkp] in R's dtype: the product's operand
  unsigned* bar;        // arrival counter, zero at launch
  int t, n, k, gk, gkp, gkr;  // gkp: G*K rounded up to 4; gkr: to BKT
  int cb, rb, passes;   // column blocks, row blocks, 32-row passes a block
  int act;              // RNN: 0 relu, 1 sigmoid, 2 tanh
  int dz_bf16;          // dz (and dgiri) in bf16, else f32
};

// Four values of row n, columns k..k+3 of the exchange buffer, read at L2 as
// f32; zeros where n >= N or k >= G*K (lanes past G*K are zeroed where they
// are stored: the load is a prefetch).
__device__ __forceinline__ float4 load_q4(const float* src, int stride, int n, int k, int nn,
                                          int kk) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n < nn && k < kk) v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)n * stride + k));
  return v;
}
__device__ __forceinline__ float4 load_q4(const __nv_bfloat16* src, int stride, int n, int k,
                                          int nn, int kk) {
  uint2 u = make_uint2(0u, 0u);
  if (n < nn && k < kk) u = __ldcg(reinterpret_cast<const uint2*>(src + (size_t)n * stride + k));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store_cg(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void store_cg(__nv_bfloat16* p, float v) {
  const unsigned short u = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  asm volatile("st.global.cg.u16 [%0], %1;" : : "l"(p), "h"(u) : "memory");
}

// element i of an output emitted in f32 or (rounded to nearest even) bf16
__device__ __forceinline__ void store_out(void* base, int bf16, size_t i, float v) {
  if (bf16) static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(base)[i] = v;
}

template <int CELL, typename RT>
__global__ void __launch_bounds__(BWD_THREADS, 1) seq_bwd(BwdParams p) {
  constexpr int G = CellTraits<CELL>::G;
  constexpr int NRES = CELL == RNN ? 1 : 5;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dzT = reinterpret_cast<float*>(smem);    // [BKT][BROWS], then partial sums
  RT* rs = reinterpret_cast<RT*>(smem + B_SMEM);  // [gkr][BU]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int prg = lane / 4, pug = lane % 4;      // product: rows prg*4.., units pug*4..
  const int eu = tid % BU, erg = tid / BU;       // epilogue: unit eu, rows erg*ERM..
  // staging: quad i of a thread is row st_row(i), chunk positions st_col(i)..+3;
  // a warp loads 4 rows x 8 quads at a time, whole 128-byte lines in f32
  const auto st_row = [&](int i) { return 4 * ((warp + KGROUPS * i) % (BROWS / 4)) + lane / 8; };
  const auto st_col = [&](int i) {
    return 4 * (8 * ((warp + KGROUPS * i) / (BROWS / 4)) + lane % 8);
  };
  const int cbi = blockIdx.x % p.cb, rbi = blockIdx.x / p.cb;
  const int j0 = cbi * BU, j = j0 + eu;
  const int nn = p.n, kk = p.k, gk = p.gk;
  const size_t nk = (size_t)nn * kk;
  const RT* rtsrc = static_cast<const RT*>(p.rt);

  // -- R^T's columns j0 .. j0+15, every row, once; zeros past G*K and K ------
  const int total = p.gkr * BU;
  for (int e0 = tid; e0 < total; e0 += BWD_THREADS * BRB) {
    RT v[BRB];
#pragma unroll
    for (int u = 0; u < BRB; ++u) {
      const int e = e0 + u * BWD_THREADS;
      const int g = e / BU, c = e % BU;
      v[u] = e < total && g < gk && j0 + c < kk ? rtsrc[(size_t)g * kk + j0 + c]
                                                : from_f<RT>(0.f);
    }
#pragma unroll
    for (int u = 0; u < BRB; ++u)
      if (e0 + u * BWD_THREADS < total) rs[e0 + u * BWD_THREADS] = v[u];
  }

  float dbacc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) dbacc[g] = 0.f;
  const int first_row = rbi * p.passes * BROWS;
  for (int s = 0; s <= p.t; ++s) {
    const int t = p.t - 1 - s;  // -1: only dh0's product is left
    const RT* xin = static_cast<const RT*>(p.xbuf) + (size_t)((t + 1) & 1) * nn * p.gkp;
    RT* xout = static_cast<RT*>(p.xbuf) + (size_t)(t & 1) * nn * p.gkp;

    for (int ps = 0; ps < p.passes; ++ps) {
      const int n0 = first_row + ps * BROWS;
      if (n0 >= nn) break;  // block-uniform

      // the epilogue's operands, loaded before the product so that their
      // latency hides behind it; hv: the dh carry, cv: dc (LSTM) or dh*zi (GRU)
      float dv[ERM], pv[ERM], cv[ERM], hv[ERM], rv[ERM][NRES];
#pragma unroll
      for (int r = 0; r < ERM; ++r) {
        const int n = n0 + erg * ERM + r;
        const size_t e = (size_t)n * kk + j;
        dv[r] = pv[r] = cv[r] = hv[r] = 0.f;
#pragma unroll
        for (int m = 0; m < NRES; ++m) rv[r][m] = 0.f;
        if (n >= nn || j >= kk) continue;
        if (t >= 0) {
          const size_t st = (size_t)t * nk + e;
          dv[r] = p.dhs[st];
#pragma unroll
          for (int m = 0; m < NRES; ++m) rv[r][m] = p.res[m][st];
          if (CELL != RNN) pv[r] = t == 0 ? p.s0[e] : p.res[4][st - nk];
        }
        if (s == 0) {
          hv[r] = p.dht[e];
          if (CELL == LSTM) cv[r] = p.dct[e];
        } else if (CELL != RNN) {
          cv[r] = p.carry[e];
        }
      }

      // -- dh_prev = dz_{t+1} @ R^T for the pass's rows and the block's units
      if (s > 0) {
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
        float4 pre[BQPT];
#pragma unroll
        for (int i = 0; i < BQPT; ++i)
          pre[i] = load_q4(xin, p.gkp, n0 + st_row(i), st_col(i), nn, gk);
        for (int c0 = 0; c0 < p.gkr; c0 += BKT) {
          __syncthreads();  // the previous chunk is consumed
#pragma unroll
          for (int i = 0; i < BQPT; ++i) {
            const int q = st_col(i), kq = c0 + q, r = st_row(i);
            dzT[dz_at(q + 0, r)] = pre[i].x;
            dzT[dz_at(q + 1, r)] = kq + 1 < gk ? pre[i].y : 0.f;
            dzT[dz_at(q + 2, r)] = kq + 2 < gk ? pre[i].z : 0.f;
            dzT[dz_at(q + 3, r)] = kq + 3 < gk ? pre[i].w : 0.f;
          }
          __syncthreads();
          if (c0 + BKT < p.gkr) {
#pragma unroll
            for (int i = 0; i < BQPT; ++i)
              pre[i] = load_q4(xin, p.gkp, n0 + st_row(i), c0 + BKT + st_col(i), nn, gk);
          }
          const RT* rrow = rs + (size_t)(c0 + warp * KPW) * BU + pug * 4;
#pragma unroll
          for (int kq = 0; kq < KPW; ++kq) {
            const float4 d = *reinterpret_cast<const float4*>(dzT + dz_at(warp * KPW + kq, prg * 4));
            const float4 rq = load_r4(rrow + kq * BU);
            const float d4[4] = {d.x, d.y, d.z, d.w};
            const float r4[4] = {rq.x, rq.y, rq.z, rq.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(d4[a], r4[b], acc[a][b]);
          }
        }
        // the four warps' sums of each (row, unit), added in warp order
        __syncthreads();
        float* red = dzT;  // [KGROUPS][BROWS][BU]
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(red + (warp * BROWS + prg * 4 + a) * BU + pug * 4) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < ERM; ++r) {
          const int row = erg * ERM + r;
          float sum = red[row * BU + eu];
#pragma unroll
          for (int q = 1; q < KGROUPS; ++q) sum = __fadd_rn(sum, red[(q * BROWS + row) * BU + eu]);
          hv[r] = CELL == GRU ? __fadd_rn(cv[r], sum) : sum;
        }
      }

      if (t < 0) {  // the last product: dh0
#pragma unroll
        for (int r = 0; r < ERM; ++r) {
          const int n = n0 + erg * ERM + r;
          if (n < nn && j < kk) p.dh0[(size_t)n * kk + j] = hv[r];
        }
        continue;
      }

      // -- the gate-gradient epilogue of step t, in the JAX kernel's order:
      // every product and sum rounded on its own, as the plain version's
      // separate torch ops round them
#pragma unroll
      for (int r = 0; r < ERM; ++r) {
        const int n = n0 + erg * ERM + r;
        if (n >= nn || j >= kk) continue;
        const size_t e = (size_t)n * kk + j;
        const float dh = __fadd_rn(dv[r], hv[r]);
        float dz[G];
        float dgiri = 0.f;
        if constexpr (CELL == LSTM) {
          const float i = rv[r][0], g = rv[r][1], f = rv[r][2], o = rv[r][3];
          const float tc = tanhf(rv[r][4]);
          const float dc = __fadd_rn(
              cv[r], __fmul_rn(__fmul_rn(dh, o), __fsub_rn(1.f, __fmul_rn(tc, tc))));
          dz[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, g), i), __fsub_rn(1.f, i));
          dz[1] = __fmul_rn(__fmul_rn(dc, i), __fsub_rn(1.f, __fmul_rn(g, g)));
          dz[2] = __fmul_rn(__fmul_rn(__fmul_rn(dc, pv[r]), f), __fsub_rn(1.f, f));
          dz[3] = __fmul_rn(__fmul_rn(__fmul_rn(dh, tc), o), __fsub_rn(1.f, o));
          p.carry[e] = __fmul_rn(dc, f);
        } else if constexpr (CELL == GRU) {
          const float ri = rv[r][0], zi = rv[r][1], gi = rv[r][2], zrg = rv[r][3];
          dz[1] = __fmul_rn(__fmul_rn(__fmul_rn(dh, __fsub_rn(pv[r], gi)), zi),
                            __fsub_rn(1.f, zi));
          dz[2] = __fmul_rn(__fmul_rn(dh, __fsub_rn(1.f, zi)),
                            __fsub_rn(1.f, __fmul_rn(gi, gi)));
          dz[0] = __fmul_rn(__fmul_rn(__fmul_rn(dz[2], zrg), ri), __fsub_rn(1.f, ri));
          dgiri = __fmul_rn(dz[2], ri);
          p.carry[e] = __fmul_rn(dh, zi);
        } else {
          const float h = rv[r][0];
          const float d = p.act == 0   ? (h > 0.f ? 1.f : 0.f)
                          : p.act == 1 ? __fmul_rn(h, __fsub_rn(1.f, h))
                                       : __fsub_rn(1.f, __fmul_rn(h, h));
          dz[0] = __fmul_rn(dh, d);
        }
        const size_t zrow = ((size_t)t * nn + n) * gk + j;
        RT* xrow = xout + (size_t)n * p.gkp + j;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          store_out(p.dz, p.dz_bf16, zrow + (size_t)g * kk, dz[g]);
          store_cg(xrow + (size_t)g * kk, CELL == GRU && g == 2 ? dgiri : dz[g]);
          dbacc[g] = __fadd_rn(dbacc[g], dz[g]);
        }
        if (CELL == GRU) store_out(p.dgiri, p.dz_bf16, (size_t)t * nk + e, dgiri);
      }
    }

    if (t == 0) {  // the block's partial sums of db, its threads in order
      __syncthreads();
      float* red = dzT;  // [BWD_THREADS / BU][BU][G]
#pragma unroll
      for (int g = 0; g < G; ++g) red[(erg * BU + eu) * G + g] = dbacc[g];
      __syncthreads();
      if (tid < BU * G) {
        const int u = tid % BU, g = tid / BU;
        if (j0 + u < kk) {
          float sum = red[u * G + g];
          for (int q = 1; q < BWD_THREADS / BU; ++q) sum = __fadd_rn(sum, red[(q * BU + u) * G + g]);
          __stcg(p.dbp + (size_t)rbi * gk + (size_t)g * kk + j0 + u, sum);
        }
      }
    }
    if (t >= 0) grid_barrier(p.bar, (unsigned)(s + 1) * gridDim.x);
  }

  // db: the row blocks' partial sums, in row-block order
  if (rbi == 0 && tid < BU * G) {
    const int u = tid % BU, g = tid / BU;
    if (j0 + u < kk) {
      const size_t col = (size_t)g * kk + j0 + u;
      float sum = __ldcg(p.dbp + col);
      for (int b = 1; b < p.rb; ++b) sum = __fadd_rn(sum, __ldcg(p.dbp + (size_t)b * gk + col));
      p.db[col] = sum;
    }
  }
}

struct Plan {
  size_t smem;
  int cb, passes, grid;
};

// The grid of a cooperative kernel with `cb` column blocks over `rpass`
// passes of rows, or -2 if it cannot run: `smem` exceeds a block's shared
// memory, the column blocks cannot all be resident at once, or the card has
// no cooperative launch.  The fewest passes a block that fit the card.
int coop_plan(const void* kern, int threads, size_t smem, int cb, int rpass, int device,
              Plan* pl) {
  pl->smem = smem;
  if (smem > (size_t)SHARED_MAX) return -2;
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (!coop) return -2;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long slots = (long long)per_sm * sms;
  pl->cb = cb;
  if (cb > slots) return -2;
  const long long rb_max = slots / cb;
  const int rb0 = rb_max < rpass ? (int)rb_max : rpass;
  pl->passes = (rpass + rb0 - 1) / rb0;
  const int rb = (rpass + pl->passes - 1) / pl->passes;
  pl->grid = cb * rb;
  return 0;
}

// The launch plan of the forward kernel for N x K: its R slice is K x COLS.
template <int CELL, typename RT, bool TRAIN>
int plan(int n, int k, int device, Plan* pl) {
  const int kr = (k + KT - 1) / KT * KT;
  const int units = CellTraits<CELL>::UNITS;
  return coop_plan(reinterpret_cast<const void*>(seq_fwd<CELL, RT, TRAIN>), THREADS,
                   (size_t)H_SMEM + (size_t)kr * COLS * sizeof(RT), (k + units - 1) / units,
                   (n + ROWS - 1) / ROWS, device, pl);
}

// The launch plan of the backward kernel for N x K: its R^T slice is
// round_up(G*K, BKT) x BU, G times the forward's rows for as many values.
template <int CELL, typename RT>
int plan_bwd(int n, int k, int device, Plan* pl) {
  const long long gkr = ((long long)CellTraits<CELL>::G * k + BKT - 1) / BKT * BKT;
  const long long smem = B_SMEM + gkr * BU * (long long)sizeof(RT);
  if (smem > SHARED_MAX) return -2;
  return coop_plan(reinterpret_cast<const void*>(seq_bwd<CELL, RT>), BWD_THREADS,
                   (size_t)smem, (k + BU - 1) / BU, (n + BROWS - 1) / BROWS, device, pl);
}

template <int CELL, typename RT, bool TRAIN>
int launch(Params p, int device, cudaStream_t st) {
  Plan pl;
  const int rc = plan<CELL, RT, TRAIN>(p.n, p.k, device, &pl);
  if (rc) return rc;
  if ((long long)p.t * pl.grid > 0xffffffffLL) return -2;  // the barrier's count
  p.kp = (p.k + 3) / 4 * 4;
  p.kr = (p.k + KT - 1) / KT * KT;
  p.cb = pl.cb;
  p.passes = pl.passes;
  p.h0_vec = p.k % 4 == 0 && reinterpret_cast<uintptr_t>(p.h0) % 16 == 0;
  cudaError_t e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(seq_fwd<CELL, RT, TRAIN>),
                                  dim3(pl.grid), dim3(THREADS), args, pl.smem, st);
  cudaGetLastError();  // clear the sticky launch error, returned below
  return (int)e;
}

template <int CELL, bool TRAIN>
int dispatch(const Params& p, int r_bf16, int device, void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  return r_bf16 ? launch<CELL, __nv_bfloat16, TRAIN>(p, device, st)
                : launch<CELL, float, TRAIN>(p, device, st);
}

template <int CELL>
int fits(int n, int k, int r_bf16, int device) {
  Plan pl;
  int rc = r_bf16 ? plan<CELL, __nv_bfloat16, false>(n, k, device, &pl)
                  : plan<CELL, float, false>(n, k, device, &pl);
  if (rc == 0 && CELL != RNN)
    rc = r_bf16 ? plan<CELL, __nv_bfloat16, true>(n, k, device, &pl)
                : plan<CELL, float, true>(n, k, device, &pl);
  return rc;
}

template <int CELL, typename RT>
int launch_bwd(BwdParams p, int device, cudaStream_t st) {
  Plan pl;
  const int rc = plan_bwd<CELL, RT>(p.n, p.k, device, &pl);
  if (rc) return rc;
  if ((long long)p.t * pl.grid > 0xffffffffLL) return -2;  // the barrier's count
  p.gk = CellTraits<CELL>::G * p.k;
  p.gkp = (p.gk + 3) / 4 * 4;
  p.gkr = (p.gk + BKT - 1) / BKT * BKT;
  p.cb = pl.cb;
  p.rb = pl.grid / pl.cb;
  p.passes = pl.passes;
  cudaError_t e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(seq_bwd<CELL, RT>),
                                  dim3(pl.grid), dim3(BWD_THREADS), args, pl.smem, st);
  cudaGetLastError();  // clear the sticky launch error, returned below
  return (int)e;
}

template <int CELL>
int dispatch_bwd(const BwdParams& p, int r_bf16, int device, void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  return r_bf16 ? launch_bwd<CELL, __nv_bfloat16>(p, device, st)
                : launch_bwd<CELL, float>(p, device, st);
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t) on device
// `device` and returns its cudaError_t (0 = launched); -2 means the shape is
// outside the kernel's envelope (shared memory of a block, or more blocks
// than the card holds at once), and nothing was launched (cuda_build.launch
// raises it as ValueError).  The caller allocates every output and the
// scratch: hbuf [2, N, round_up(K, 4)] f32 and bar, one 32-bit word, which the
// entry point zeroes on the stream.  r_bf16 selects the dtype of R; a null
// residual pointer (cs for the LSTM, ris for the GRU) selects the inference
// form.  Nothing synchronises.  T, N, K >= 1.
extern "C" int xsmm_lstm_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                             const float* c0, float* hs, float* ht, float* ct, float* cs,
                             float* is, float* gs, float* fs, float* os, float* hbuf,
                             unsigned* bar, int t, int n, int k, int device, void* stream) {
  Params p{zx, r, h0, c0, hs, ht, ct, {cs, is, gs, fs, os}, hbuf, bar, t, n, k,
           0, 0, 0, 0, 0, 0};
  return cs ? dispatch<LSTM, true>(p, r_bf16, device, stream)
            : dispatch<LSTM, false>(p, r_bf16, device, stream);
}

extern "C" int xsmm_gru_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                            float* hs, float* ht, float* ris, float* zis, float* gis,
                            float* zrgs, float* hbuf, unsigned* bar, int t, int n, int k,
                            int device, void* stream) {
  Params p{zx, r, h0, nullptr, hs, ht, nullptr, {ris, zis, gis, zrgs, nullptr}, hbuf, bar,
           t, n, k, 0, 0, 0, 0, 0, 0};
  return ris ? dispatch<GRU, true>(p, r_bf16, device, stream)
             : dispatch<GRU, false>(p, r_bf16, device, stream);
}

extern "C" int xsmm_rnn_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                            float* hs, float* ht, int act, float* hbuf, unsigned* bar, int t,
                            int n, int k, int device, void* stream) {
  if (act < 0 || act > 2) return -1;
  Params p{zx, r, h0, nullptr, hs, ht, nullptr, {nullptr, nullptr, nullptr, nullptr, nullptr},
           hbuf, bar, t, n, k, 0, 0, 0, 0, act, 0};
  return dispatch<RNN, false>(p, r_bf16, device, stream);
}

// 1 if the kernel of a cell with `gates` gates (4 LSTM, 3 GRU, 1 RNN) and R of
// `r_itemsize` bytes (4 f32, 2 bf16) runs N x K on device `device`, in both
// forms; 0 if the shape is outside its envelope; -1 for gates or itemsize it
// does not take; else a cudaError_t.
extern "C" int xsmm_rnn_seq_fits(int n, int k, int gates, int r_itemsize, int device) {
  if (r_itemsize != 2 && r_itemsize != 4) return -1;
  if (n < 1 || k < 1) return 0;
  cudaSetDevice(device);
  const int bf = r_itemsize == 2;
  int rc;
  switch (gates) {
    case 4: rc = fits<LSTM>(n, k, bf, device); break;
    case 3: rc = fits<GRU>(n, k, bf, device); break;
    case 1: rc = fits<RNN>(n, k, bf, device); break;
    default: return -1;
  }
  return rc == 0 ? 1 : rc == -2 ? 0 : rc;
}

// The backward entry points, as the forward's: one launch on `stream`, the
// cudaError_t returned (-2: outside the envelope, nothing launched).  The
// caller allocates the outputs (dz [T, N, G*K] and, for the GRU, dgiri
// [T, N, K] in f32 or, with dz_bf16, bf16; dh0, dc0 [N, K] f32; db [G*K] f32)
// and the scratch: dbp [ceil(N/32), G*K] f32, xbuf [2, N, round_up(G*K, 4)]
// in R's dtype, the GRU's carry [N, K] f32, and bar, one 32-bit word.  rt is
// R^T [G*K, K].  Residuals and states are f32; T, N, K >= 1.
extern "C" int xsmm_lstm_seq_bwd(const float* dhs, const float* is, const float* gs,
                                 const float* fs, const float* os, const float* cs,
                                 const float* c0, const float* dht, const float* dct,
                                 const void* rt, int r_bf16, void* dz, int dz_bf16, float* dh0,
                                 float* dc0, float* db, float* dbp, void* xbuf, unsigned* bar,
                                 int t, int n, int k, int device, void* stream) {
  BwdParams p{};
  p.dhs = dhs;
  p.res[0] = is; p.res[1] = gs; p.res[2] = fs; p.res[3] = os; p.res[4] = cs;
  p.s0 = c0; p.dht = dht; p.dct = dct; p.rt = rt;
  p.dz = dz; p.dh0 = dh0; p.carry = dc0; p.db = db; p.dbp = dbp; p.xbuf = xbuf; p.bar = bar;
  p.t = t; p.n = n; p.k = k; p.dz_bf16 = dz_bf16;
  return dispatch_bwd<LSTM>(p, r_bf16, device, stream);
}

extern "C" int xsmm_gru_seq_bwd(const float* dhs, const float* ris, const float* zis,
                                const float* gis, const float* zrgs, const float* hs,
                                const float* h0, const float* dht, const void* rt, int r_bf16,
                                void* dzx, void* dgiri, int dz_bf16, float* dh0, float* carry,
                                float* db, float* dbp, void* xbuf, unsigned* bar, int t, int n,
                                int k, int device, void* stream) {
  BwdParams p{};
  p.dhs = dhs;
  p.res[0] = ris; p.res[1] = zis; p.res[2] = gis; p.res[3] = zrgs; p.res[4] = hs;
  p.s0 = h0; p.dht = dht; p.rt = rt;
  p.dz = dzx; p.dgiri = dgiri; p.dh0 = dh0; p.carry = carry; p.db = db; p.dbp = dbp;
  p.xbuf = xbuf; p.bar = bar;
  p.t = t; p.n = n; p.k = k; p.dz_bf16 = dz_bf16;
  return dispatch_bwd<GRU>(p, r_bf16, device, stream);
}

extern "C" int xsmm_rnn_seq_bwd(const float* dhs, const float* hs, const float* dht,
                                const void* rt, int r_bf16, void* dz, int dz_bf16, int act,
                                float* dh0, float* db, float* dbp, void* xbuf, unsigned* bar,
                                int t, int n, int k, int device, void* stream) {
  if (act < 0 || act > 2) return -1;
  BwdParams p{};
  p.dhs = dhs;
  p.res[0] = hs;
  p.dht = dht; p.rt = rt;
  p.dz = dz; p.dh0 = dh0; p.db = db; p.dbp = dbp; p.xbuf = xbuf; p.bar = bar;
  p.t = t; p.n = n; p.k = k; p.act = act; p.dz_bf16 = dz_bf16;
  return dispatch_bwd<RNN>(p, r_bf16, device, stream);
}

// 1 if the backward kernel of a cell with `gates` gates and R of `r_itemsize`
// bytes runs N x K on device `device`; 0 if the shape is outside its envelope
// (its R^T slice is G times the forward's height, so the two envelopes
// differ); -1 for gates or itemsize it does not take; else a cudaError_t.
extern "C" int xsmm_rnn_seq_bwd_fits(int n, int k, int gates, int r_itemsize, int device) {
  if (r_itemsize != 2 && r_itemsize != 4) return -1;
  if (n < 1 || k < 1) return 0;
  cudaSetDevice(device);
  const bool bf = r_itemsize == 2;
  Plan pl;
  int rc;
  switch (gates) {
    case 4:
      rc = bf ? plan_bwd<LSTM, __nv_bfloat16>(n, k, device, &pl)
              : plan_bwd<LSTM, float>(n, k, device, &pl);
      break;
    case 3:
      rc = bf ? plan_bwd<GRU, __nv_bfloat16>(n, k, device, &pl)
              : plan_bwd<GRU, float>(n, k, device, &pl);
      break;
    case 1:
      rc = bf ? plan_bwd<RNN, __nv_bfloat16>(n, k, device, &pl)
              : plan_bwd<RNN, float>(n, k, device, &pl);
      break;
    default: return -1;
  }
  return rc == 0 ? 1 : rc == -2 ? 0 : rc;
}
