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
//   (dnn/rnn_seq.seq_bwd_kernel_ok), and xsmm_rnn_seq_bwd_scratch the
//   sizes of their scratch; their design is set out above seq_bwd.
//
// Backward bound on an H100 SXM at N 128, K 512, T 32, each input read once
// and each output written once: LSTM dhs and five residuals 50 MB + dz 33.5
// MB (f32) + R 4.2 MB, ~26 us of bytes against dz @ R^T's 2*T*N*4K*K = 8.6
// GFLOP, 0.128 ms at the FP32 rate (operations); with bf16 R and dz, ~21 us
// of bytes.  GRU 0.096 ms, RNN 0.032 ms (f32, operations).  Like the
// forward, the product runs on FFMA and T barriers add a latency floor; its
// design (above seq_bwd) keeps each block's share of the FFMA work at the
// issue floor and moves only partial sums of dh between blocks.
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
//     zeroed by the entry point before the launch; after __syncthreads,
//     thread 0 arrives with a release reduction (the block's writes, which
//     the block barrier ordered before it, are visible to whoever acquires
//     the count) and spins on an acquire load until the count reaches
//     (t+1) x gridDim.x, then __syncthreads.  No full fence: it measured
//     0.3-0.4 us a step slower in all six kernels.
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
// scheduler); the grid barrier takes ~1.2 us a step, the epilogue ~1 us.
// mma.sync / wgmma for the bf16 cells, and a larger register tile, are the
// ways up.
//
// Envelope: the R slice and the 8 KB h chunk must fit a block's shared
// memory (K <= 832 with f32 R, K <= 1728 with bf16 R), and the column blocks
// (ceil(K/16), RNN ceil(K/64)) must be co-resident.  Any N and K inside it,
// and any T >= 1, work: rows >= N, units >= K and k >= K are masked.  The
// backward's: its G*16 x round_up(K, 8) R^T slice with the dz tile and db's
// row-pair sums (LSTM K <= 832 f32, <= 1664 bf16; GRU K <= 1109 f32), and
// ceil(K/16) co-resident column blocks.

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
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" : : "l"(bar) : "memory");
    unsigned v;
    for (long long spin = 0;; ++spin) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
      if (v >= target) break;
      // a block that never arrives (it cannot: the launch is cooperative)
      // would hang the card; after seconds of waiting, fail the launch
      if (spin > (1LL << 28)) __trap();
      __nanosleep(32);
    }
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
// then dh_prev = dz_t @ R^T, whose sum over the G*K positions of dz_t is the
// only part that crosses blocks.
//   * Units.  A block owns BU hidden units j (dh, dc and the G dz columns
//     j, K+j, ... of each: its P = G*BU positions) and, in each row chunk,
//     ppc passes of BROWS rows: 16 units x 32 rows for the LSTM and GRU, 32
//     x 16 for the simple RNN, and 16 x 32 for it with f32 R where the
//     32-unit slice does not fit (K > 1768; BwdGeo).
//   * Row chunks.  A pass of the grid covers rb x BROWS rows (rb row
//     blocks).  The exchange buffer holds a chunk of ppc such passes, ppc
//     the most whose buffer stays within PBUF_MB (in the 50 MB L2); a
//     larger N is cut into chunks, and the kernel runs the whole reverse
//     scan over each chunk in turn (rows never mix), with a grid barrier
//     between chunks.  A pass's share of the buffer is 2 x cb x cb x rb x
//     BROWS x BU = 2 x cb x grid x 512 f32 (cb column blocks, grid = cb x
//     rb <= the card's resident blocks): 8.4 MB for the LSTM at K 512 (cb
//     32, grid 128; 3 passes a chunk), 21 MB for the GRU at K 1144 (cb 72,
//     grid 72; 1 pass); whatever N, the buffer is at most PBUF_MB or one
//     pass's share.
//   * R^T.  The block's slice is the P rows of R^T [G*K, K] of its positions,
//     every column: P x K values in shared memory for all T steps (128 KB in
//     f32 for the LSTM at K = 512).  With bf16 R it is held as f32 (exact)
//     where that fits the card, else as bf16; the sums are the same.
//   * Product, split by the block's own units.  After the epilogue the block
//     holds its P dz columns for its rows (dz rounded to R's dtype; for the
//     GRU [dri, dzi, dgi*ri]) in shared memory, and multiplies them by its
//     slice: a partial dh_prev, BROWS rows x all K columns, summed over its P
//     positions in position order (gate-major) in one FMA chain per value.
//     Each of the 8 warps owns BROWS/4 rows x 256 columns, a thread
//     BROWS/4 x 8 values: its dz as float4 broadcasts and 8 R^T values per
//     8 x BROWS/4 FMA.  Nothing is staged from other blocks for the product.
//   * Exchange.  Each block writes its partial into a double-buffered f32
//     buffer with st.global.cg, laid out by destination block, so that after
//     the grid barrier each block reads the partials of its own units from
//     every column block as one contiguous run, with ld.global.cg (L2, never
//     the non-coherent path), 8 bytes a thread, and adds them in
//     column-block order: dh_prev.  Per step the L2
//     carries 2 x column blocks x N x K x 4 bytes, where the first design,
//     which staged all G*K dz columns into every column block, read G / 2
//     (LSTM, GRU) or G (RNN) times as much.
//   * Operands.  The epilogue's operands (dhs, the residuals, the carries) of
//     the next (step, pass) are loaded before the current product, so their
//     latency is behind it.
//   * Carries.  dc (LSTM) and dh * zi (GRU) are kept in device memory by the
//     thread that owns the (row, unit); the LSTM's running dc is dc0's buffer.
//   * db.  Per step and row group (a pass's BROWS rows) the block sums its
//     rows in a fixed order (a thread's two rows, then the row pairs in
//     order) and adds that to the group's running sum in dbp [ceil(N/BROWS),
//     G*K]; after the last barrier the blocks of row block 0 add the groups
//     in order.  No atomics, and the order depends on no launch plan.
//   * T barriers a chunk, and one between chunks: the last product (dh0)
//     needs all of dz_0, and the next chunk reuses the exchange buffer.
//     With ppc passes a chunk, a step's barrier is shared by its passes.
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;
constexpr int TK = 8;                         // columns of a thread's product tile
constexpr int BKC = 512;                      // columns of dh_prev a product chunk covers
constexpr int PCH = 32;                       // partials a thread keeps in flight
constexpr int BRB = 32;                       // R^T loads a thread keeps in flight
constexpr int PBUF_MB = 32;                   // a row chunk's exchange buffer, at most

// A backward geometry: BU hidden units a block owns (its P = G*BU
// positions) and BROWS rows a chunk.  The LSTM and GRU take 16 units x 32
// rows; the simple RNN, one position a unit, takes twice the units and half
// the rows (UNITS_RNN), which halves the partials it exchanges for the same
// work.
constexpr int UNITS = 16, UNITS_RNN = 32;
template <int CELL, int BU_>
struct BwdGeo {
  static constexpr int BU = BU_;
  static constexpr int BROWS = 512 / BU;
  static constexpr int P = CellTraits<CELL>::G * BU;
  static constexpr int TR = BROWS / 4;        // rows of a thread's product tile
  static constexpr int EG = BWD_THREADS / BU; // the epilogue's row pairs a pass
  static constexpr int DZS = BROWS + 4;       // row stride of the dz tile (floats)
  static_assert((BROWS / TR) * (BKC / TK) == BWD_THREADS && BKC == 2 * 256,
                "8 warps: 4 row groups x 2 halves of 256 columns");
  static_assert(EG * 2 == BROWS, "a thread's epilogue is 2 rows of a unit");
};
constexpr int ERM = 2;                        // rows of a thread's epilogue

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
  float* dbp;           // [ceil(N/BROWS), G*K]: the row groups' running sums of db
  float* pbuf;          // [2, cb, cb, rb*BROWS, BU]: the column blocks' partial products
  unsigned* bar;        // arrival counter, zero at launch
  int t, n, k, gk, kp, ks;  // kp: K rounded up to 8; ks: the slice's row stride
  int cb, rb, chunks, ppc;  // column blocks, row blocks, row chunks, passes a chunk
  int act;              // RNN: 0 relu, 1 sigmoid, 2 tanh
  int dz_bf16;          // dz (and dgiri) in bf16, else f32
};

// element i of an output emitted in f32 or (rounded to nearest even) bf16
__device__ __forceinline__ void store_out(void* base, int bf16, size_t i, float v) {
  if (bf16) static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(base)[i] = v;
}

// The 8 R^T values of lane `lane` at position row `row` (the slice's row
// stride is ks): with an f32 slice columns lane*4 .. +3 and 128 + lane*4 .. +3
// of the warp's 256, with a bf16 slice lane*8 .. +7 (one 16-byte load each
// time, the warp's lanes on consecutive addresses).
__device__ __forceinline__ int rt_col(const float*, int lane, int i) {
  return i < 4 ? lane * 4 + i : 128 + lane * 4 + i - 4;
}
__device__ __forceinline__ int rt_col(const __nv_bfloat16*, int lane, int i) {
  return lane * 8 + i;
}
__device__ __forceinline__ void load_rt8(const float* p, int lane, float (&b)[TK]) {
  const float4 x = *reinterpret_cast<const float4*>(p + lane * 4);
  const float4 y = *reinterpret_cast<const float4*>(p + 128 + lane * 4);
  b[0] = x.x; b[1] = x.y; b[2] = x.z; b[3] = x.w;
  b[4] = y.x; b[5] = y.y; b[6] = y.z; b[7] = y.w;
}
__device__ __forceinline__ void load_rt8(const __nv_bfloat16* p, int lane, float (&b)[TK]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p + lane * 8);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[2 * i] = __uint_as_float(w[i] << 16);
    b[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename RS>
__device__ __forceinline__ RS to_rs(float v);
template <>
__device__ __forceinline__ float to_rs<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_rs<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float r_as_f(float v) { return v; }
__device__ __forceinline__ float r_as_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// RT: R's dtype; RS: the dtype the slice is held in (RT, or float for bf16
// R); BU: the units a block owns
template <int CELL, typename RT, typename RS, int BU_>
__global__ void __launch_bounds__(BWD_THREADS, 1) seq_bwd(BwdParams p) {
  constexpr int G = CellTraits<CELL>::G;
  using Geo = BwdGeo<CELL, BU_>;
  constexpr int BU = Geo::BU, BROWS = Geo::BROWS, P = Geo::P, TR = Geo::TR;
  constexpr int DZS = Geo::DZS, EG = Geo::EG;
  constexpr int NRES = CELL == RNN ? 1 : 5;
  extern __shared__ __align__(16) unsigned char smem[];
  RS* rs = reinterpret_cast<RS*>(smem);          // [P][ks]
  float* dzs = reinterpret_cast<float*>(smem + (size_t)P * p.ks * sizeof(RS));  // [P][DZS]
  float* red = dzs + P * DZS;                    // [EG][P]: db's row-pair sums
  float* dhb = red + EG * P;                     // [BROWS][BU]: dh_prev of the pass

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tr = warp % 4, kh = warp / 4;       // product: rows tr*TR.., half kh
  const int eu = tid % BU, erg = tid / BU;       // epilogue: unit eu, rows erg*ERM..
  const int cbi = blockIdx.x % p.cb, rbi = blockIdx.x / p.cb;
  const int j0 = cbi * BU, j = j0 + eu;
  const int nn = p.n, kk = p.k, gk = p.gk;
  const size_t nk = (size_t)nn * kk;
  // pbuf [2][cb][cb][crows][BU]: the partial of source block c for the
  // units of destination block d at the chunk's row n is [d][c][n][u], so
  // that a block reads its partials as one contiguous run
  const int crows = p.rb * p.ppc * BROWS;       // rows of a chunk
  const size_t pstride = (size_t)p.cb * p.cb * crows * BU;
  const RT* rtsrc = static_cast<const RT*>(p.rt);

  // -- R^T's rows g*K + j0 + u of the block's positions q = g*BU + u, every
  // column, once; zeros past K and for units past K ---------------------------
  const int total = P * p.ks;
  for (int e0 = tid; e0 < total; e0 += BWD_THREADS * BRB) {
    RS v[BRB];
#pragma unroll
    for (int u = 0; u < BRB; ++u) {
      const int e = e0 + u * BWD_THREADS;
      const int q = e / p.ks, c = e % p.ks;
      const int g = q / BU, jj = j0 + q % BU;
      v[u] = e < total && jj < kk && c < kk
                 ? to_rs<RS>(r_as_f(rtsrc[((size_t)g * kk + jj) * kk + c]))
                 : to_rs<RS>(0.f);
    }
#pragma unroll
    for (int u = 0; u < BRB; ++u)
      if (e0 + u * BWD_THREADS < total) rs[e0 + u * BWD_THREADS] = v[u];
  }

  // The epilogue's operands of one (step t, pass) unit: dv dhs[t], rv the
  // residuals, pv the state before step t, cv the carry (dc for the LSTM,
  // dh*zi for the GRU; dct at the first step), hv dht at the first step;
  // and dbrun, the running db sum of the unit's row group, read by the
  // thread that wrote it.  The operands of the next unit are loaded before
  // the product of the current one, so that they arrive behind it.
  struct Ops {
    float dv[ERM], pv[ERM], cv[ERM], hv[ERM], rv[ERM][NRES], dbrun;
  };
  const int dq = tid, dcol = (dq / BU) * kk + j0 + dq % BU;
  const auto load_ops = [&](int t, int n0, Ops& o) {
    const int s = p.t - 1 - t;
#pragma unroll
    for (int r = 0; r < ERM; ++r) {
      const int n = n0 + erg * ERM + r;
      const size_t e = (size_t)n * kk + j;
      o.dv[r] = o.pv[r] = o.cv[r] = o.hv[r] = 0.f;
#pragma unroll
      for (int m = 0; m < NRES; ++m) o.rv[r][m] = 0.f;
      if (n >= nn || j >= kk) continue;
      if (t >= 0) {
        const size_t st = (size_t)t * nk + e;
        o.dv[r] = p.dhs[st];
#pragma unroll
        for (int m = 0; m < NRES; ++m) o.rv[r][m] = p.res[m][st];
        if (CELL != RNN) o.pv[r] = t == 0 ? p.s0[e] : p.res[4][st - nk];
      }
      if (s == 0) {
        o.hv[r] = p.dht[e];
        if (CELL == LSTM) o.cv[r] = p.dct[e];
      } else if (CELL != RNN) {
        o.cv[r] = p.carry[e];
      }
    }
    o.dbrun = 0.f;
    if (t >= 0 && s > 0 && dq < P && j0 + dq % BU < kk)
      o.dbrun = p.dbp[(size_t)(n0 / BROWS) * gk + dcol];
  };
  Ops cur, nxt;
  bool have = false;  // cur holds the operands of the unit at hand
  unsigned barriers = 0;

  for (int ch = 0; ch < p.chunks; ++ch) {
    const int nc = ch * crows;                          // the chunk's first row
    const int first_row = nc + rbi * p.ppc * BROWS;     // the block's first row in it
    for (int s = 0; s <= p.t; ++s) {
      const int t = p.t - 1 - s;  // -1: only dh0's product is left
      const float* pin = p.pbuf + (size_t)((s + 1) & 1) * pstride;
      float* pout = p.pbuf + (size_t)(s & 1) * pstride;
      // every block, with rows or not: after each step and between chunks
      if (s > 0 || ch > 0) grid_barrier(p.bar, ++barriers * gridDim.x);

      for (int ps = 0; ps < p.ppc; ++ps) {
        const int n0 = first_row + ps * BROWS;
        if (n0 >= nn) break;  // block-uniform
        if (!have) load_ops(t, n0, cur);
        have = false;

        // -- dh_prev: the column blocks' partials of the block's rows and
        // units, added in column-block order.  Thread (row rn, units 2*pr,
        // 2*pr + 1) reads 8 bytes a partial (a warp 4 or 2 whole rows); the
        // sums reach the epilogue's mapping through shared memory.
        if (s > 0) {
          const int rn = tid / (BU / 2), pr = tid % (BU / 2), n = n0 + rn;
          float2 sum = make_float2(0.f, 0.f);
          if (n < nn) {
            const float* src = pin + ((size_t)cbi * p.cb * crows + n - nc) * BU + 2 * pr;
            const size_t cs = (size_t)crows * BU;  // from one source block to the next
            for (int c0 = 0; c0 < p.cb; c0 += PCH) {
              float2 v[PCH];
#pragma unroll
              for (int i = 0; i < PCH; ++i)
                v[i] = make_float2(0.f, 0.f);
#pragma unroll
              for (int i = 0; i < PCH; ++i)
                if (c0 + i < p.cb)
                  v[i] = __ldcg(reinterpret_cast<const float2*>(src + (c0 + i) * cs));
#pragma unroll
              for (int i = 0; i < PCH; ++i)
                if (c0 + i < p.cb)
                  sum = c0 + i == 0 ? v[i]
                                    : make_float2(__fadd_rn(sum.x, v[i].x),
                                                  __fadd_rn(sum.y, v[i].y));
            }
          }
          __syncthreads();  // the previous pass is done with dhb
          reinterpret_cast<float2*>(dhb)[tid] = sum;
          __syncthreads();
#pragma unroll
          for (int r = 0; r < ERM; ++r) {
            const float x = dhb[(erg * ERM + r) * BU + eu];
            cur.hv[r] = CELL == GRU ? __fadd_rn(cur.cv[r], x) : x;
          }
        }

        if (t < 0) {  // the last product: dh0
#pragma unroll
          for (int r = 0; r < ERM; ++r) {
            const int n = n0 + erg * ERM + r;
            if (n < nn && j < kk) p.dh0[(size_t)n * kk + j] = cur.hv[r];
          }
          continue;
        }

        // -- the gate-gradient epilogue of step t, in the JAX kernel's order:
        // every product and sum rounded on its own, as the plain version's
        // separate torch ops round them
        float dbs[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dbs[g] = 0.f;
#pragma unroll
        for (int r = 0; r < ERM; ++r) {
          const int n = n0 + erg * ERM + r;
          float dz[G], op[G];
#pragma unroll
          for (int g = 0; g < G; ++g) dz[g] = op[g] = 0.f;
          if (n < nn && j < kk) {
            const size_t e = (size_t)n * kk + j;
            const float dh = __fadd_rn(cur.dv[r], cur.hv[r]);
            if constexpr (CELL == LSTM) {
              const float i = cur.rv[r][0], g = cur.rv[r][1];
              const float f = cur.rv[r][2], o = cur.rv[r][3];
              const float tc = tanhf(cur.rv[r][4]);
              const float dc = __fadd_rn(
                  cur.cv[r], __fmul_rn(__fmul_rn(dh, o), __fsub_rn(1.f, __fmul_rn(tc, tc))));
              dz[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, g), i), __fsub_rn(1.f, i));
              dz[1] = __fmul_rn(__fmul_rn(dc, i), __fsub_rn(1.f, __fmul_rn(g, g)));
              dz[2] = __fmul_rn(__fmul_rn(__fmul_rn(dc, cur.pv[r]), f), __fsub_rn(1.f, f));
              dz[3] = __fmul_rn(__fmul_rn(__fmul_rn(dh, tc), o), __fsub_rn(1.f, o));
              p.carry[e] = __fmul_rn(dc, f);
            } else if constexpr (CELL == GRU) {
              const float ri = cur.rv[r][0], zi = cur.rv[r][1];
              const float gi = cur.rv[r][2], zrg = cur.rv[r][3];
              dz[1] = __fmul_rn(__fmul_rn(__fmul_rn(dh, __fsub_rn(cur.pv[r], gi)), zi),
                                __fsub_rn(1.f, zi));
              dz[2] = __fmul_rn(__fmul_rn(dh, __fsub_rn(1.f, zi)),
                                __fsub_rn(1.f, __fmul_rn(gi, gi)));
              dz[0] = __fmul_rn(__fmul_rn(__fmul_rn(dz[2], zrg), ri), __fsub_rn(1.f, ri));
              p.carry[e] = __fmul_rn(dh, zi);
            } else {
              const float h = cur.rv[r][0];
              const float d = p.act == 0   ? (h > 0.f ? 1.f : 0.f)
                              : p.act == 1 ? __fmul_rn(h, __fsub_rn(1.f, h))
                                           : __fsub_rn(1.f, __fmul_rn(h, h));
              dz[0] = __fmul_rn(dh, d);
            }
#pragma unroll
            for (int g = 0; g < G; ++g) op[g] = dz[g];
            const size_t zrow = ((size_t)t * nn + n) * gk + j;
#pragma unroll
            for (int g = 0; g < G; ++g) store_out(p.dz, p.dz_bf16, zrow + (size_t)g * kk, dz[g]);
            if constexpr (CELL == GRU) {
              op[2] = __fmul_rn(dz[2], cur.rv[r][0]);  // dgi * ri
              store_out(p.dgiri, p.dz_bf16, (size_t)t * nk + e, op[2]);
            }
          }
          // the product's operand, rounded to R's dtype; zero past N and K
#pragma unroll
          for (int g = 0; g < G; ++g) {
            dzs[(g * BU + eu) * DZS + erg * ERM + r] = to_r<RT>(op[g]);
            dbs[g] = r == 0 ? dz[g] : __fadd_rn(dbs[g], dz[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) red[erg * P + g * BU + eu] = dbs[g];
        __syncthreads();  // the dz tile and the row-pair sums are in

        // db of the unit's row group: its row pairs in order, then the step
        if (dq < P && j0 + dq % BU < kk) {
          float x = red[dq];
#pragma unroll
          for (int q = 1; q < EG; ++q) x = __fadd_rn(x, red[q * P + dq]);
          p.dbp[(size_t)(n0 / BROWS) * gk + dcol] = s == 0 ? x : __fadd_rn(cur.dbrun, x);
        }

        // the next unit's operands, in flight during the product
        if (ps + 1 < p.ppc && n0 + BROWS < nn) load_ops(t, n0 + BROWS, nxt);
        else load_ops(t - 1, first_row, nxt);
        have = true;

        // -- the block's partial of dh_{t-1}: its P positions x every column
        for (int kc = 0; kc < p.kp; kc += BKC) {
          const int kb = kc + kh * (BKC / 2);        // the warp's first column
          if (kb >= kk || n0 + tr * TR >= nn) continue;  // warp-uniform
          float acc[TR][TK];
#pragma unroll
          for (int a = 0; a < TR; ++a)
#pragma unroll
            for (int b = 0; b < TK; ++b) acc[a][b] = 0.f;
          const float* drow = dzs + tr * TR;
          const RS* rrow = rs + kb;
#pragma unroll 8
          for (int q = 0; q < P; ++q) {
            float a8[TR];
            if constexpr (TR % 4 == 0) {
#pragma unroll
              for (int v = 0; v < TR / 4; ++v) {
                const float4 d = *reinterpret_cast<const float4*>(drow + q * DZS + 4 * v);
                a8[4 * v] = d.x; a8[4 * v + 1] = d.y; a8[4 * v + 2] = d.z; a8[4 * v + 3] = d.w;
              }
            } else {
              static_assert(TR == 2, "a thread's rows: 2 or a multiple of 4");
              const float2 d = *reinterpret_cast<const float2*>(drow + q * DZS);
              a8[0] = d.x; a8[1] = d.y;
            }
            float b8[TK];
            load_rt8(rrow + (size_t)q * p.ks, lane, b8);
#pragma unroll
            for (int a = 0; a < TR; ++a)
#pragma unroll
              for (int b = 0; b < TK; ++b) acc[a][b] = fmaf(a8[a], b8[b], acc[a][b]);
          }
#pragma unroll
          for (int a = 0; a < TR; ++a) {
            const int n = n0 + tr * TR + a;
            if (n >= nn) break;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = kb + rt_col(rs, lane, 4 * h);   // 4 consecutive columns
              if (c < kk)
                __stcg(reinterpret_cast<float4*>(
                           pout + (((size_t)(c / BU) * p.cb + cbi) * crows + n - nc) * BU +
                               c % BU),
                       make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2],
                                   acc[a][4 * h + 3]));
            }
          }
        }
        __syncthreads();  // the dz tile is consumed before the next pass writes it
        cur = nxt;
      }
    }
  }

  // db: the row groups' sums, in group order
  if (rbi == 0 && tid < P && j0 + tid % BU < kk) {
    const size_t col = (size_t)(tid / BU) * kk + j0 + tid % BU;
    const int groups = (nn + BROWS - 1) / BROWS;
    float sum = __ldcg(p.dbp + col);
#pragma unroll 8
    for (int b = 1; b < groups; ++b) sum = __fadd_rn(sum, __ldcg(p.dbp + (size_t)b * gk + col));
    p.db[col] = sum;
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

// The launch plan of the backward kernel for N x K with its R^T slice held
// in RS and BU units a block: the slice is P = G*BU rows of round_up(K, 8)
// values, then the dz tile and db's row-pair sums.  Plan::passes is the
// number of passes of the grid over N (bwd_chunks groups them).
template <int CELL, typename RT, typename RS, int BU>
int plan_bwd(int n, int k, int device, Plan* pl) {
  using Geo = BwdGeo<CELL, BU>;
  const long long ks = (k + 7LL) / 8 * 8;
  const long long smem = Geo::P * ks * (long long)sizeof(RS) +
                         ((long long)Geo::P * (Geo::DZS + Geo::EG) + Geo::BROWS * Geo::BU) * 4;
  if (smem > SHARED_MAX) return -2;
  return coop_plan(reinterpret_cast<const void*>(seq_bwd<CELL, RT, RS, BU>), BWD_THREADS,
                   (size_t)smem, (k + BU - 1) / BU, (n + Geo::BROWS - 1) / Geo::BROWS, device,
                   pl);
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

// The backward kernel's form for N x K: its plan, whether the R^T slice is
// held in f32 (always with f32 R; with bf16 R where the f32 slice fits the
// card, else in bf16: the sums are the same either way), and the units a
// block owns (the simple RNN with f32 R takes 16 where 32 do not fit).
struct BwdForm {
  Plan pl;
  bool slice_f32;
  int bu, chunks, ppc;
};

// The row chunks of a plan with BU units a block: ppc passes of the grid a
// chunk, the most whose exchange buffer stays within PBUF_MB (at least
// one), spread evenly over the chunks.
void bwd_chunks(BwdForm* f) {
  const long long rb = f->pl.grid / f->pl.cb;
  const long long pass_bytes = 2LL * f->pl.cb * f->pl.cb * rb * 512 * 4;
  long long ppc = ((long long)PBUF_MB << 20) / pass_bytes;
  if (ppc < 1) ppc = 1;
  if (ppc > f->pl.passes) ppc = f->pl.passes;
  f->chunks = (int)((f->pl.passes + ppc - 1) / ppc);
  f->ppc = (f->pl.passes + f->chunks - 1) / f->chunks;
}

template <int CELL, typename RT, typename RS, int BU>
int launch_bwd(BwdParams p, const BwdForm& f, cudaStream_t st) {
  const Plan& pl = f.pl;
  // the barrier's count: T a chunk and one between chunks
  if ((long long)(p.t + 1) * f.chunks * pl.grid > 0xffffffffLL) return -2;
  p.gk = CellTraits<CELL>::G * p.k;
  p.kp = (p.k + 7) / 8 * 8;
  p.ks = p.kp;
  p.cb = pl.cb;
  p.rb = pl.grid / pl.cb;
  p.chunks = f.chunks;
  p.ppc = f.ppc;
  cudaError_t e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(seq_bwd<CELL, RT, RS, BU>),
                                  dim3(pl.grid), dim3(BWD_THREADS), args, pl.smem, st);
  cudaGetLastError();  // clear the sticky launch error, returned below
  return (int)e;
}

template <int CELL>
int bwd_plan(int n, int k, int r_bf16, int device, BwdForm* f) {
  constexpr int BU = CELL == RNN ? UNITS_RNN : UNITS;
  f->slice_f32 = true;
  f->bu = BU;
  if (!r_bf16) {
    const int rc = plan_bwd<CELL, float, float, BU>(n, k, device, &f->pl);
    if (rc != -2 || CELL != RNN) return rc;
    f->bu = UNITS;
    return plan_bwd<CELL, float, float, UNITS>(n, k, device, &f->pl);
  }
  const int rc = plan_bwd<CELL, __nv_bfloat16, float, BU>(n, k, device, &f->pl);
  if (rc != -2) return rc;
  f->slice_f32 = false;
  return plan_bwd<CELL, __nv_bfloat16, __nv_bfloat16, BU>(n, k, device, &f->pl);
}

template <int CELL>
int bwd_form(int n, int k, int r_bf16, int device, BwdForm* f) {
  const int rc = bwd_plan<CELL>(n, k, r_bf16, device, f);
  if (rc == 0) bwd_chunks(f);
  return rc;
}

int bwd_form_any(int gates, int n, int k, int r_bf16, int device, BwdForm* f) {
  switch (gates) {
    case 4: return bwd_form<LSTM>(n, k, r_bf16, device, f);
    case 3: return bwd_form<GRU>(n, k, r_bf16, device, f);
    case 1: return bwd_form<RNN>(n, k, r_bf16, device, f);
    default: return -1;
  }
}

template <int CELL>
int dispatch_bwd(const BwdParams& p, int r_bf16, int device, void* stream) {
  constexpr int BU = CELL == RNN ? UNITS_RNN : UNITS;
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  BwdForm f;
  const int rc = bwd_form<CELL>(p.n, p.k, r_bf16, device, &f);
  if (rc) return rc;
  if (!r_bf16)
    return f.bu == BU ? launch_bwd<CELL, float, float, BU>(p, f, st)
                      : launch_bwd<CELL, float, float, UNITS>(p, f, st);
  return f.slice_f32 ? launch_bwd<CELL, __nv_bfloat16, float, BU>(p, f, st)
                     : launch_bwd<CELL, __nv_bfloat16, __nv_bfloat16, BU>(p, f, st);
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
// and the scratch: dbp and pbuf f32 of the sizes xsmm_rnn_seq_bwd_scratch
// gives, the GRU's carry [N, K] f32, and bar, one 32-bit word.  rt is R^T
// [G*K, K].  Residuals and states are f32; T, N, K >= 1.
extern "C" int xsmm_lstm_seq_bwd(const float* dhs, const float* is, const float* gs,
                                 const float* fs, const float* os, const float* cs,
                                 const float* c0, const float* dht, const float* dct,
                                 const void* rt, int r_bf16, void* dz, int dz_bf16, float* dh0,
                                 float* dc0, float* db, float* dbp, float* pbuf, unsigned* bar,
                                 int t, int n, int k, int device, void* stream) {
  BwdParams p{};
  p.dhs = dhs;
  p.res[0] = is; p.res[1] = gs; p.res[2] = fs; p.res[3] = os; p.res[4] = cs;
  p.s0 = c0; p.dht = dht; p.dct = dct; p.rt = rt;
  p.dz = dz; p.dh0 = dh0; p.carry = dc0; p.db = db; p.dbp = dbp; p.pbuf = pbuf; p.bar = bar;
  p.t = t; p.n = n; p.k = k; p.dz_bf16 = dz_bf16;
  return dispatch_bwd<LSTM>(p, r_bf16, device, stream);
}

extern "C" int xsmm_gru_seq_bwd(const float* dhs, const float* ris, const float* zis,
                                const float* gis, const float* zrgs, const float* hs,
                                const float* h0, const float* dht, const void* rt, int r_bf16,
                                void* dzx, void* dgiri, int dz_bf16, float* dh0, float* carry,
                                float* db, float* dbp, float* pbuf, unsigned* bar, int t, int n,
                                int k, int device, void* stream) {
  BwdParams p{};
  p.dhs = dhs;
  p.res[0] = ris; p.res[1] = zis; p.res[2] = gis; p.res[3] = zrgs; p.res[4] = hs;
  p.s0 = h0; p.dht = dht; p.rt = rt;
  p.dz = dzx; p.dgiri = dgiri; p.dh0 = dh0; p.carry = carry; p.db = db; p.dbp = dbp;
  p.pbuf = pbuf; p.bar = bar;
  p.t = t; p.n = n; p.k = k; p.dz_bf16 = dz_bf16;
  return dispatch_bwd<GRU>(p, r_bf16, device, stream);
}

extern "C" int xsmm_rnn_seq_bwd(const float* dhs, const float* hs, const float* dht,
                                const void* rt, int r_bf16, void* dz, int dz_bf16, int act,
                                float* dh0, float* db, float* dbp, float* pbuf, unsigned* bar,
                                int t, int n, int k, int device, void* stream) {
  if (act < 0 || act > 2) return -1;
  BwdParams p{};
  p.dhs = dhs;
  p.res[0] = hs;
  p.dht = dht; p.rt = rt;
  p.dz = dz; p.dh0 = dh0; p.db = db; p.dbp = dbp; p.pbuf = pbuf; p.bar = bar;
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
  BwdForm f;
  const int rc = bwd_form_any(gates, n, k, r_itemsize == 2, device, &f);
  return rc == 0 ? 1 : rc == -2 ? 0 : rc;
}

// The f32 elements of the backward kernel's scratch for N x K, into
// floats[0] (dbp: db's row groups, [ceil(N/BROWS), G*K]) and floats[1]
// (pbuf: the partials of one row chunk, [2, cb, cb, rb*ppc*BROWS, BU]); 0,
// or as the entry points (-2: outside the envelope).  `stream` is not used.
extern "C" int xsmm_rnn_seq_bwd_scratch(int n, int k, int gates, int r_itemsize,
                                        long long* floats, int device, void*) {
  if (r_itemsize != 2 && r_itemsize != 4) return -1;
  if (n < 1 || k < 1) return -2;
  cudaSetDevice(device);
  BwdForm f;
  const int rc = bwd_form_any(gates, n, k, r_itemsize == 2, device, &f);
  if (rc) return rc;
  const long long brows = 512 / f.bu, rb = f.pl.grid / f.pl.cb;
  floats[0] = (n + brows - 1) / brows * gates * (long long)k;
  floats[1] = 2LL * f.pl.cb * f.pl.cb * rb * f.ppc * brows * f.bu;
  return 0;
}
