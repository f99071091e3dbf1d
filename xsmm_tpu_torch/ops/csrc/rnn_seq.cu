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
// preferred_element_type=f32.  With bf16 R each sum is one FFMA chain in k
// order, which the plain version's k-order addcmul reproduces exactly; with
// f32 R (the split form below) the sum runs in another order, as cuBLAS's
// does, within f32 rounding of it.  Gate math in f32: sigmoid =
// 1/(1+expf(-x)), tanhf, and every product and sum of the gate math rounded
// on its own, as torch's separate ops round them; built without
// --use_fast_math.
//
// Design of the forward: one persistent cooperative kernel over all T steps.
// The TPU runs the T grid in order on one core with R resident in VMEM and
// h, c in scratch; here blocks run in parallel and only h is sequential
// (step t needs all of h_{t-1} for every output column):
//   * Columns.  A block owns 16 hidden units: its G*16 gate columns (the G
//     gates of each unit, so the gate epilogue of a (row, unit) is local to
//     one thread; GRU's r * (h@R)_g needs nothing from other blocks).  At N
//     128, K 512 that is 32 column blocks x 4 row blocks of 32 rows: 128 of
//     the 132 SMs in every cell.
//   * R.  The block's R slice stays in shared memory for all T steps (the
//     counterpart of the TPU's resident R), loaded once 16 (bf16: 8) bytes a
//     thread, 4 rows at a time, and transposed in registers, while step 0's
//     first h chunk and epilogue operands are in flight.
//   * What bounds the product.  A lane gets one 32-bit value an SM cycle
//     from shared memory, broadcast or not (the first design's 4 x 4 tile and
//     a 2 x 4 tile measured within 10 % of that count), so a thread's tile
//     sets the loads an FFMA: (rows + columns) / (rows x columns).  Three
//     forms, the kernel's own choice (fwd_form, counted by the wrapper):
//     - split (f32 R): the 8 warps split each 64-k chunk, 8 k a warp, over
//       the block's whole 32 x G*16 tile, a lane an 8 x 8 register tile (the
//       simple RNN 4 x 4): one load per 4 FFMA, the FFMA issue floor's rate;
//       the warps' partial sums meet in shared memory and are added in warp
//       order: another order than the plain version's product (cuBLAS's),
//       within f32 rounding a step, which the simple RNN's tanh over R of
//       gain above 1 carries further over many steps, as it carries any
//       other order's (PERF.md, PR 11).  It needs the slice and the 64 KB
//       of partials in a block (LSTM, GRU K <= 576; simple RNN K <= 2112),
//       else the chain form.
//     - chain (bf16 R, and f32 R beyond the split form): a thread owns 2
//       rows x its unit's G gates, one FFMA chain in k order each; per 4 k,
//       h as one 16-byte load (bf16: the thread's two rows packed as bf16
//       pairs, so 4 k of both in one load) and R as one 4-k vector a gate
//       (bf16 pairs, unpacked by a shift and a mask).
//     - wide (bf16 R, LSTM and simple RNN, where it fills the card and
//       covers no more padded rows than the chain form, weighed by the
//       values each tile loads an FFMA: plan_form): the first design's
//       geometry and code (4 warps, 4 x 4 tiles, h staged transposed, three
//       blocks an SM with the bf16 slice), which the chain form's tile
//       cannot match once the card is full (the simple RNN from N 512, the
//       LSTM at N 768, 1536, 3072, 4100 of those timed at K 512).
//     A tensor-core product (mma.sync m16n8k16, bf16 -> f32) was measured
//     and not kept: its sums leave k order, and the bf16 recurrence carried
//     that to the 1e-3 gate or past it (PERF.md, PR 11).
//     The form is planned once a shape (fwd_form keeps the plans) and the
//     entry points return the form they launched.
//   * h exchange.  Each step every block writes its h columns into a
//     double-buffered [2, N, Kp] f32 buffer in device memory (Kp = K rounded
//     up to 4; 512 KB at N 128, K 512, held in L2), then a grid barrier, then
//     every block stages the rows of h_{t-1} it needs, 64 k at a time, into
//     shared memory (a warp reads two rows' 256 contiguous bytes),
//     prefetching the next chunk into registers during the product.  The
//     buffer is read with ld.global.cg (L2, never the non-coherent or L1
//     path) and written with st.global.cg, so no block reads a stale h.
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
//     the blocks an SM keeps resident (launch.cuh) x the SM count, so a
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
// The forms run the product on FFMA, so the FP32 rate bounds them in both
// dtypes; and T sequential steps add a latency floor of T x (barrier + one
// step) that neither bound counts.  What holds them, with clock64() stamps
// (dnn/seq_profile.py) on the H100 at N 128, K 512, T 32, in us a step: LSTM
// f32 (split) 10.8 = product 7.6 (h staging 0.8 of it) + epilogue with the
// partial sums 1.1 + barrier 1.0 + operands 0.5, the product 1.9x its FFMA
// issue floor of 4 us; LSTM bf16 (chain) 13.8 = product 10.9 + barrier 1.2
// + epilogue 0.6 + operands 0.5, issue-bound (61 instructions a warp per 4 k
// for 32 FFMA: the bf16 unpacking is 24 of them); simple RNN 5.2 (f32) and
// 6.5 (bf16), the barrier a fifth of it.
//
// Envelope: the slice and the h chunk must fit a block's shared memory
// (K <= 832 with f32 R, K <= 1728 with bf16 R for the LSTM; the GRU's and
// simple RNN's slices are 3/4 and 1/4 of it), and the column blocks
// (ceil(K/16); the wide form's simple RNN ceil(K/64)) must be co-resident.
// Any N and K inside it, and any T >= 1, work: rows >= N, units >= K and
// k >= K are masked.  The backward's: its G*16 x round_up(K, 8) R^T slice
// with the dz tile and db's row-pair sums (LSTM K <= 832 f32, <= 1664
// bf16; GRU K <= 1109 f32), and ceil(K/16) co-resident column blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;       // 8 warps: 2 row halves x 4 quarters of the units
constexpr int RM = 2;              // rows a thread owns in a pass, 8 apart
constexpr int ROWS = 16 * RM;      // rows a pass: 2 row halves x 8 lanes x RM
constexpr int KT = 64;             // k staged per chunk of h
constexpr int HS = KT + 4;         // row stride of the h chunk (floats): a warp's
                                   // 8 rows of one float4 fall on distinct banks
constexpr int H_SMEM = ROWS * HS * 4;         // 8.5 KB: h[ROWS][HS] f32
constexpr int QPT = ROWS * KT / 4 / THREADS;  // float4 quads a thread stages a chunk
constexpr int RB = 4;              // R-slice tasks a thread keeps in flight (4 or G loads each)
constexpr int QU = 16;             // k quads the chain form's product loop unrolls
static_assert(QPT >= 1 && ROWS * KT / 4 == QPT * THREADS, "the h chunk in whole quads");

enum Cell { LSTM = 0, GRU = 1, RNN = 2 };

template <int CELL>
struct CellTraits {
  static constexpr int G = CELL == LSTM ? 4 : CELL == GRU ? 3 : 1;
  static constexpr int UNITS = 16;  // hidden units a forward block owns, every cell
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
  int cb, passes;      // column blocks; ROWS-row passes a block
  int act;             // RNN: 0 relu, 1 sigmoid, 2 tanh
  int h0_vec;          // h0's rows are 16-byte aligned
  int r_vec;           // R's rows take 4-value vector loads (K % 4 == 0, R aligned)
};

// The two bf16 halves of a packed u32 as f32 (exact; a shift measured faster
// than a byte permute for the low half)
__device__ __forceinline__ float lo_f(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// four consecutive values of a slice in shared memory (4 k of one unit and
// gate), as f32
__device__ __forceinline__ float4 load_r4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_r4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(lo_f(u.x), hi_f(u.x), lo_f(u.y), hi_f(u.y));
}

// ... and the same four stored (bf16 values are exact in f32: no rounding)
__device__ __forceinline__ void store_r4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store_r4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// R values j .. j+3 of one gate block of one row of R (p points at the first),
// the first `live` of them inside K and the rest zero, as f32; one 16- or
// 8-byte load where `vec`
__device__ __forceinline__ void r_quad(const float* p, bool vec, int live, float (&v)[4]) {
  if (vec && live == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < live ? p[i] : 0.f;
  }
}
__device__ __forceinline__ void r_quad(const __nv_bfloat16* p, bool vec, int live,
                                       float (&v)[4]) {
  if (vec && live == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < live ? __bfloat162float(p[i]) : 0.f;
  }
}

template <typename RT>
__device__ __forceinline__ float to_r(float v) {
  if constexpr (sizeof(RT) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

// as torch.sigmoid on the card computes it: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
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

// The epilogue's operands of one pass, loaded before its product so that
// their latency hides behind it: zx of the G columns of unit j, and c (LSTM)
// or h_{t-1} (GRU) of the unit, for the rows n0 + ra + rstep*r (r < RM).
template <int CELL>
__device__ __forceinline__ void load_ops(const Params& p, int t, int n0, int ra, int rstep,
                                         int j, const float* hin, int hstride,
                                         float (&zv)[RM][CellTraits<CELL>::G],
                                         float (&sv)[RM]) {
  constexpr int G = CellTraits<CELL>::G;
  const int nn = p.n, kk = p.k;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int n = n0 + ra + rstep * r;
    const bool live = n < nn && j < kk;
    const float* zrow = p.zx + ((size_t)t * nn + n) * G * kk + j;
#pragma unroll
    for (int g = 0; g < G; ++g) zv[r][g] = live ? zrow[(size_t)g * kk] : 0.f;
    const size_t e = (size_t)n * kk + j;
    sv[r] = 0.f;
    if (CELL == LSTM && live) sv[r] = t == 0 ? p.c0[e] : p.ct[e];
    if (CELL == GRU && live) sv[r] = __ldcg(hin + (size_t)n * hstride + j);
  }
}

// The gate epilogue of row n, unit j at step t from z = (h@R)[n][g*K + j]:
// every product and sum rounded on its own (no FMA contraction), as the
// plain versions' separate torch ops round them.
template <int CELL, bool TRAIN>
__device__ __forceinline__ void cell_out(const Params& p, int t, int n, int j,
                                         const float (&z)[CellTraits<CELL>::G],
                                         const float (&zv)[CellTraits<CELL>::G], float s,
                                         float* hout, bool last) {
  const int nn = p.n, kk = p.k;
  const size_t srow = ((size_t)t * nn + n) * kk;   // row n of step t, [T,N,K]
  float h2;
  if constexpr (CELL == RNN) {
    const float x = __fadd_rn(zv[0], z[0]);
    h2 = p.act == 0 ? (x > 0.f ? x : 0.f) : p.act == 1 ? sigmoid(x) : tanhf(x);
  } else if constexpr (CELL == LSTM) {
    const float i = sigmoid(__fadd_rn(zv[0], z[0]));
    const float g = tanhf(__fadd_rn(zv[1], z[1]));
    const float f = sigmoid(__fadd_rn(zv[2], z[2]));
    const float o = sigmoid(__fadd_rn(zv[3], z[3]));
    const float c2 = __fadd_rn(__fmul_rn(f, s), __fmul_rn(i, g));
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
    const float ri = sigmoid(__fadd_rn(zv[0], z[0]));
    const float zi = sigmoid(__fadd_rn(zv[1], z[1]));
    const float zrg = z[2];
    const float gi = tanhf(__fadd_rn(zv[2], __fmul_rn(ri, zrg)));
    h2 = __fadd_rn(__fmul_rn(__fsub_rn(1.f, zi), gi), __fmul_rn(zi, s));
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

// The h chunk of a pass (ROWS rows x KT k from k0), staged by the block in
// quads: task e = threadIdx.x + THREADS*i is row e / (KT/4), quad e % (KT/4)
// (a warp reads two rows' 256 contiguous bytes), or, with bf16 R, the row
// pair e / (KT/4) (rows pair_row(e) and + 8) of one quad.
__device__ __forceinline__ int pair_row(int pair) { return pair < 8 ? pair : pair + 8; }

template <bool PACK>
__device__ __forceinline__ void prefetch_h(const Params& p, const float* hin, int hstride,
                                           bool hvec, int n0, int k0, float4 (&pre)[QPT]) {
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int e = threadIdx.x + THREADS * (PACK ? i / 2 : i);
    const int q = k0 + 4 * (e % (KT / 4));
    const int row = PACK ? pair_row(e / (KT / 4)) + 8 * (i % 2) : e / (KT / 4);
    pre[i] = load_h4(hin, hstride, hvec, n0 + row, q, p.n, p.k);
  }
}

// ... and stored: f32 rows hsm[row][HS]; or (PACK, bf16 R) rounded to bf16
// with each row pair packed, hsm[pair][HS] as u32 (row pair_row in the low
// half)
template <bool PACK>
__device__ __forceinline__ void stage_h(float* hsm, int k0, int kk, const float4 (&pre)[QPT]) {
  // lanes k + i >= K of an aligned load are zeroed here
  const auto lanes = [&](const float4& v, int k) {
    return make_float4(v.x, k + 1 < kk ? v.y : 0.f, k + 2 < kk ? v.z : 0.f,
                       k + 3 < kk ? v.w : 0.f);
  };
  if constexpr (PACK) {
    static_assert(QPT % 2 == 0, "row pairs");
    const auto pk = [](float lo, float hi) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      return *reinterpret_cast<const unsigned*>(&v);
    };
#pragma unroll
    for (int i = 0; i < QPT / 2; ++i) {
      const int e = threadIdx.x + THREADS * i, q = 4 * (e % (KT / 4));
      const float4 a = lanes(pre[2 * i], k0 + q), b = lanes(pre[2 * i + 1], k0 + q);
      *reinterpret_cast<uint4*>(hsm + (e / (KT / 4)) * HS + q) =
          make_uint4(pk(a.x, b.x), pk(a.y, b.y), pk(a.z, b.z), pk(a.w, b.w));
    }
  } else {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int e = threadIdx.x + THREADS * i, q = 4 * (e % (KT / 4));
      *reinterpret_cast<float4*>(hsm + (e / (KT / 4)) * HS + q) = lanes(pre[i], k0 + q);
    }
  }
}

// -- The chain form: one FFMA chain in k order per output -------------------
// bf16 R (every K), and f32 R where the split form does not fit.  A thread
// owns rows ra and ra + 8 of a pass and the G gates of its unit u: per 4 k,
// h as one 16-byte load (f32: one a row; bf16: the row pair's packed
// values) and R as one 4-k vector a gate.  RS: the dtype the R slice is held
// in (R's own).
template <int CELL, typename RS, bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1) seq_fwd(Params p) {
  constexpr int G = CellTraits<CELL>::G;
  constexpr int UNITS = CellTraits<CELL>::UNITS;
  constexpr bool PACK = sizeof(RS) == 2;                  // bf16 R: h in packed row pairs
  extern __shared__ __align__(16) unsigned char smem[];
  float* hsm = reinterpret_cast<float*>(smem);            // [ROWS][HS] (PACK: pairs)
  RS* rs = reinterpret_cast<RS*>(smem + H_SMEM);          // [kr/4][G][UNITS][4]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int u = (warp % 4) * 4 + lane % 4;                // the thread's unit
  const int ra = (warp / 4) * (ROWS / 2) + lane / 4;      // its rows ra + 8*r
  const int pr = warp / 4 * 8 + lane / 4;                 // bf16: its row pair
  const int cbi = blockIdx.x % p.cb, rbi = blockIdx.x / p.cb;
  const int j0 = cbi * UNITS, j = j0 + u;
  const int nn = p.n, kk = p.k;
  const size_t gk = (size_t)G * kk;
  const RS* rsrc = static_cast<const RS*>(p.r);

  const int row0 = rbi * p.passes * ROWS;
  float zv[RM][G], sv[RM];
  float4 pre[QPT];
  // step 0's first pass: its operands and first h chunk are in flight while
  // the R slice loads
  load_ops<CELL>(p, 0, row0, ra, 8, j, p.h0, kk, zv, sv);
  prefetch_h<PACK>(p, p.h0, kk, p.h0_vec != 0, row0, 0, pre);

  // -- the block's R slice, once: rs[k/4][g][u][k%4] = R[k][g*K + j0 + u].
  // A task is 4 rows k of 4 units of one gate: 4 vector loads, a 4 x 4
  // transpose in registers, 4 vector stores; RB tasks in flight.
  {
    const int ntask = p.kr / 4 * G * (UNITS / 4);
    for (int e0 = tid; e0 < ntask; e0 += THREADS * RB) {
      float v[RB][4][4];
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const int e = e0 + b * THREADS;
        const int uq = e % (UNITS / 4), g = e / (UNITS / 4) % G, k4 = e / (UNITS / 4 * G);
        const int jq = j0 + 4 * uq;
        const int ulive = e < ntask ? min(max(kk - jq, 0), 4) : 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * k4 + i;
          r_quad(rsrc + (size_t)k * gk + (size_t)g * kk + jq, p.r_vec != 0, k < kk ? ulive : 0,
                 v[b][i]);
        }
      }
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const int e = e0 + b * THREADS;
        if (e >= ntask) break;
        const int uq = e % (UNITS / 4), g = e / (UNITS / 4) % G, k4 = e / (UNITS / 4 * G);
        RS* dst = rs + (((size_t)k4 * G + g) * UNITS + 4 * uq) * 4;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store_r4(dst + 4 * c, v[b][0][c], v[b][1][c], v[b][2][c], v[b][3][c]);
      }
    }
  }

  // -- the steps
  for (int t = 0; t < p.t; ++t) {
    const float* hin = t == 0 ? p.h0 : p.hbuf + (size_t)((t - 1) & 1) * nn * p.kp;
    const int hstride = t == 0 ? kk : p.kp;
    const bool hvec = t == 0 ? p.h0_vec != 0 : true;
    float* hout = p.hbuf + (size_t)(t & 1) * nn * p.kp;
    const bool last = t + 1 == p.t;

    for (int ps = 0; ps < p.passes; ++ps) {
      const int n0 = row0 + ps * ROWS;
      if (n0 >= nn) break;  // block-uniform
      if (t > 0 || ps > 0) {
        load_ops<CELL>(p, t, n0, ra, 8, j, hin, hstride, zv, sv);
        prefetch_h<PACK>(p, hin, hstride, hvec, n0, 0, pre);
      }

      float acc[RM][G];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[r][g] = 0.f;

      for (int k0 = 0; k0 < p.kr; k0 += KT) {
        __syncthreads();  // the previous chunk is consumed
        stage_h<PACK>(hsm, k0, kk, pre);
        __syncthreads();
        if (k0 + KT < p.kr) prefetch_h<PACK>(p, hin, hstride, hvec, n0, k0 + KT, pre);
        const float* hrow = hsm + (PACK ? pr : ra) * HS;
        const RS* rrow = rs + ((size_t)(k0 / 4) * G * UNITS + u) * 4;
#pragma unroll (QU)
        for (int q = 0; q < KT / 4; ++q) {
          float hv[RM][4];
          if constexpr (PACK) {
            const uint4 x = *reinterpret_cast<const uint4*>(hrow + 4 * q);
            const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) { hv[0][i] = lo_f(w[i]); hv[1][i] = hi_f(w[i]); }
          } else {
#pragma unroll
            for (int r = 0; r < RM; ++r) {
              const float4 x = *reinterpret_cast<const float4*>(hrow + 8 * r * HS + 4 * q);
              hv[r][0] = x.x; hv[r][1] = x.y; hv[r][2] = x.z; hv[r][3] = x.w;
            }
          }
          float4 rv[G];
#pragma unroll
          for (int g = 0; g < G; ++g) rv[g] = load_r4(rrow + ((size_t)q * G + g) * UNITS * 4);
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int g = 0; g < G; ++g) {
              acc[r][g] = fmaf(hv[r][0], rv[g].x, acc[r][g]);
              acc[r][g] = fmaf(hv[r][1], rv[g].y, acc[r][g]);
              acc[r][g] = fmaf(hv[r][2], rv[g].z, acc[r][g]);
              acc[r][g] = fmaf(hv[r][3], rv[g].w, acc[r][g]);
            }
        }
      }

      // -- the gate epilogue: the thread's rows x its unit
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int n = n0 + ra + 8 * r;
        if (n < nn && j < kk) cell_out<CELL, TRAIN>(p, t, n, j, acc[r], zv[r], sv[r], hout, last);
      }
    }
    if (!last) grid_barrier(p.bar, (unsigned)(t + 1) * gridDim.x);
  }
}

// -- The split form (f32 R): the k range split over the 8 warps -------------
// Warp w takes k 8w .. 8w+7 of every KT chunk for the block's whole tile, a
// lane an 8 x 8 register tile (the simple RNN 4 x 4): per 4 k, 8 h loads of
// 4 k and 8 R loads of 4 columns for 256 FFMA, one loaded value per 4 FFMA
// (the chain form's 2 x 4 tile loads 3 per 4).  The warps' partial sums meet
// in shared memory and are added in warp order, then the epilogue maps a
// thread to rows er, er + 16 and unit eu.
constexpr int SPLIT = THREADS / 32;   // the k slices of a chunk, one a warp
constexpr int SKW = KT / SPLIT;       // k a warp a chunk
static_assert(SKW % 4 == 0, "whole quads of k a warp");

template <int CELL>
struct SplitGeo {
  static constexpr int S = CELL == RNN ? 1 : 4;                 // slots a unit (GRU's 4th zero)
  static constexpr int COLS = CellTraits<CELL>::UNITS * S;      // 64 or 16
  static constexpr int NH = CELL == RNN ? 1 : 2;                // 4-column groups a lane
  static constexpr int CGW = COLS / 4 / NH;                     // column groups a warp
  static constexpr int RGW = 32 / CGW;                          // row groups a warp
  static constexpr int LR = ROWS / RGW;                         // rows a lane, RGW apart
  static constexpr int RED = SPLIT * ROWS * COLS;               // floats of the partials
};

template <int CELL, bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1) seq_fwd_split(Params p) {
  using Geo = SplitGeo<CELL>;
  constexpr int G = CellTraits<CELL>::G, UNITS = CellTraits<CELL>::UNITS;
  constexpr int S = Geo::S, COLS = Geo::COLS, NH = Geo::NH, CGW = Geo::CGW;
  constexpr int RGW = Geo::RGW, LR = Geo::LR;
  static_assert(ROWS == 16 * RM, "the epilogue's rows er + 16 r");
  extern __shared__ __align__(16) unsigned char smem[];
  float* hsm = reinterpret_cast<float*>(smem);            // [ROWS][HS]
  float* rsl = reinterpret_cast<float*>(smem + H_SMEM);   // [kr][COLS]: slot u*S + g
  float* red = rsl + (size_t)p.kr * COLS;                 // [SPLIT][ROWS][COLS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int cg = lane % CGW, rg = lane / CGW;             // product: rows rg + RGW*i
  const int eu = tid % UNITS, er = tid / UNITS;           // epilogue: rows er + 16*r
  const int cbi = blockIdx.x % p.cb, rbi = blockIdx.x / p.cb;
  const int j0 = cbi * UNITS, j = j0 + eu;
  const int nn = p.n, kk = p.k;
  const size_t gk = (size_t)G * kk;
  const float* rsrc = static_cast<const float*>(p.r);

  const int row0 = rbi * p.passes * ROWS;
  float zv[RM][G], sv[RM];
  float4 pre[QPT];
  load_ops<CELL>(p, 0, row0, er, 16, j, p.h0, kk, zv, sv);
  prefetch_h<false>(p, p.h0, kk, p.h0_vec != 0, row0, 0, pre);

  // -- the block's R slice, once: rsl[k][u*S + g] = R[k][g*K + j0 + u].  A
  // task is one row k of 4 units: G vector loads, 4 (RNN 1) vector stores.
  {
    const int ntask = p.kr * (UNITS / 4);
    for (int e0 = tid; e0 < ntask; e0 += THREADS * RB) {
      float v[RB][G][4];
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const int e = e0 + b * THREADS, k = e / (UNITS / 4), jq = j0 + 4 * (e % (UNITS / 4));
        const int live = e < ntask && k < kk ? min(max(kk - jq, 0), 4) : 0;
#pragma unroll
        for (int g = 0; g < G; ++g)
          r_quad(rsrc + (size_t)k * gk + (size_t)g * kk + jq, p.r_vec != 0, live, v[b][g]);
      }
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const int e = e0 + b * THREADS;
        if (e >= ntask) break;
        float* dst = rsl + (size_t)(e / (UNITS / 4)) * COLS + 4 * (e % (UNITS / 4)) * S;
        if constexpr (S == 1) {
          store_r4(dst, v[b][0][0], v[b][0][1], v[b][0][2], v[b][0][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            store_r4(dst + 4 * c, v[b][0][c], v[b][1][c], v[b][2][c], G > 3 ? v[b][G - 1][c] : 0.f);
        }
      }
    }
  }

  // -- the steps
  for (int t = 0; t < p.t; ++t) {
    const float* hin = t == 0 ? p.h0 : p.hbuf + (size_t)((t - 1) & 1) * nn * p.kp;
    const int hstride = t == 0 ? kk : p.kp;
    const bool hvec = t == 0 ? p.h0_vec != 0 : true;
    float* hout = p.hbuf + (size_t)(t & 1) * nn * p.kp;
    const bool last = t + 1 == p.t;

    for (int ps = 0; ps < p.passes; ++ps) {
      const int n0 = row0 + ps * ROWS;
      if (n0 >= nn) break;  // block-uniform
      if (t > 0 || ps > 0) {
        load_ops<CELL>(p, t, n0, er, 16, j, hin, hstride, zv, sv);
        prefetch_h<false>(p, hin, hstride, hvec, n0, 0, pre);
      }

      float acc[LR][4 * NH];
#pragma unroll
      for (int i = 0; i < LR; ++i)
#pragma unroll
        for (int c = 0; c < 4 * NH; ++c) acc[i][c] = 0.f;

      for (int k0 = 0; k0 < p.kr; k0 += KT) {
        __syncthreads();  // the previous chunk is consumed
        stage_h<false>(hsm, k0, kk, pre);
        __syncthreads();
        if (k0 + KT < p.kr) prefetch_h<false>(p, hin, hstride, hvec, n0, k0 + KT, pre);
        const float* hb = hsm + rg * HS + SKW * warp;
        const float* rb = rsl + (size_t)(k0 + SKW * warp) * COLS + 4 * cg;
#pragma unroll
        for (int q = 0; q < SKW / 4; ++q) {
          float4 hv[LR];
#pragma unroll
          for (int i = 0; i < LR; ++i)
            hv[i] = *reinterpret_cast<const float4*>(hb + RGW * i * HS + 4 * q);
#pragma unroll
          for (int kq = 0; kq < 4; ++kq) {
            float4 rv[NH];
#pragma unroll
            for (int h = 0; h < NH; ++h)
              rv[h] = *reinterpret_cast<const float4*>(rb + (4 * q + kq) * COLS + 4 * CGW * h);
#pragma unroll
            for (int i = 0; i < LR; ++i) {
              const float x = kq == 0 ? hv[i].x : kq == 1 ? hv[i].y : kq == 2 ? hv[i].z : hv[i].w;
#pragma unroll
              for (int h = 0; h < NH; ++h) {
                const float r4[4] = {rv[h].x, rv[h].y, rv[h].z, rv[h].w};
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  if (S == 1 || c < G) acc[i][4 * h + c] = fmaf(x, r4[c], acc[i][4 * h + c]);
              }
            }
          }
        }
      }

      // -- the gate epilogue: the warp's partials into shared memory, their
      // sums in warp order, then rows er + 16 r x unit eu
      float* rw = red + (size_t)warp * ROWS * COLS;
#pragma unroll
      for (int i = 0; i < LR; ++i)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          *reinterpret_cast<float4*>(rw + (rg + RGW * i) * COLS + 4 * (cg + CGW * h)) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      __syncthreads();

#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int row = er + 16 * r, n = n0 + row;
        float z[G];
        const float* src = red + row * COLS + eu * S;
#pragma unroll
        for (int w = 0; w < SPLIT; ++w) {
          float x[4];
          if constexpr (S == 1) {
            x[0] = src[(size_t)w * ROWS * COLS];
          } else {
            const float4 v = *reinterpret_cast<const float4*>(src + (size_t)w * ROWS * COLS);
            x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) z[g] = w == 0 ? x[g] : __fadd_rn(z[g], x[g]);
        }
        if (n < nn && j < kk) cell_out<CELL, TRAIN>(p, t, n, j, z, zv[r], sv[r], hout, last);
      }
    }
    if (!last) grid_barrier(p.bar, (unsigned)(t + 1) * gridDim.x);
  }
}

// -- The wide form (bf16 R at large N; LSTM, simple RNN): the first design's
// geometry.  A block of 4 warps owns 16 column groups of 4 gate columns
// (LSTM: the gates of one unit; simple RNN: 4 consecutive units, 64 a
// block) and passes of 32 rows; a thread owns 4 rows x one group, each sum
// one FFMA chain in k order over h staged transposed (one float4 of 4 rows
// a k) and the group's 4 bf16 R values.  With the bf16 slice (64 KB at K
// 512) three blocks share an SM.  Its 4 x 4 tile loads as many values an
// FFMA as the LSTM's chain tile and half the simple RNN's; it loses at
// small N, where its grid leaves SMs idle (plan_form says where it is
// taken).  The GRU has no wide form: its fourth column would be a zero, and
// that tile lost to the chain form at every N measured.
constexpr int W_THREADS = 128;
constexpr int W_CG = 16;                       // column groups a block owns
constexpr int W_RM = 4;                        // rows a thread owns in a pass
constexpr int W_ROWS = W_THREADS / W_CG * W_RM;  // 32 rows a pass
constexpr int W_COLS = W_CG * 4;               // gate columns a block owns
constexpr int W_H_SMEM = KT * W_ROWS * 4;      // 8 KB: hT[KT][W_ROWS] f32
constexpr int W_SQ = W_THREADS / W_ROWS;       // staging threads a row
constexpr int W_QPT = KT / 4 / W_SQ;           // float4 quads a thread stages a chunk
constexpr int W_RB = 32;                       // R loads a thread keeps in flight

// The wide form where its grid holds at least FILL tenths of a block an SM
// and its row passes cover no more than CHAIN_COST times the rows of the
// chain form's (CHAIN_COST: the values the chain tile loads an FFMA over
// the wide tile's, 1 for the LSTM, 2 for the simple RNN); FILL 0: no wide
// form.  FILL was set from a sweep of N 128 .. 4100 at K 512 (PERF.md, PR
// 11): the simple RNN's wide form won from N 512 (grid 128) on, the
// LSTM's where three of its blocks share an SM and its passes cover no
// more rows.
constexpr int WIDE_FILL_LSTM = 20;
constexpr int WIDE_FILL_RNN = 9;

template <int CELL>
struct WideTraits {
  static constexpr int UNITS = CELL == RNN ? W_CG * 4 : W_CG;  // units a block owns
  static constexpr int FILL = CELL == LSTM ? WIDE_FILL_LSTM : CELL == RNN ? WIDE_FILL_RNN : 0;
  static constexpr int CHAIN_COST = CELL == RNN ? 2 : 1;
};

// Element e of a wide block's R slice (row k = e / W_COLS): its index in the
// shared-memory slice, and in *src its index in R, or -1 for a zero (k >= K,
// a unit >= K).
template <int CELL>
__device__ __forceinline__ int w_slot(int e, int j0, int kk, size_t gk, long long* src) {
  const int k = e / W_COLS, q = e % W_COLS;
  int g, c, j;
  if (CELL == RNN) {
    g = q / 4; c = q % 4; j = j0 + q;       // 4 consecutive units a group
  } else {
    c = q / W_CG; g = q % W_CG; j = j0 + g; // gate c of unit j
  }
  const bool live = k < kk && j < kk;
  *src = live ? (long long)k * (long long)gk + (CELL == RNN ? j : (long long)c * kk + j) : -1;
  return k * W_COLS + g * 4 + c;
}

template <int CELL, bool TRAIN>
__global__ void __launch_bounds__(W_THREADS, 1) seq_fwd_wide(Params p) {
  static_assert(CELL != GRU, "the GRU has no wide form");
  constexpr int G = CellTraits<CELL>::G;
  constexpr int UNITS = WideTraits<CELL>::UNITS;
  using RT = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hT = reinterpret_cast<float*>(smem);            // [KT][W_ROWS]
  RT* rs = reinterpret_cast<RT*>(smem + W_H_SMEM);        // [kr][W_COLS]

  const int tid = threadIdx.x;
  const int cg = tid % W_CG, rg = tid / W_CG;             // compute mapping
  const int sr = tid % W_ROWS, sq = tid / W_ROWS;         // staging mapping
  const int cbi = blockIdx.x % p.cb, rbi = blockIdx.x / p.cb;
  const int j0 = cbi * UNITS;
  const int nn = p.n, kk = p.k;
  const size_t gk = (size_t)G * kk;
  const RT* rsrc = static_cast<const RT*>(p.r);

  // -- the block's R slice, once: rs[k][cg*4 + c], W_RB loads in flight
  const int total = p.kr * W_COLS;
  for (int e0 = tid; e0 < total; e0 += W_THREADS * W_RB) {
    RT v[W_RB];
    int dst[W_RB];
#pragma unroll
    for (int u = 0; u < W_RB; ++u) {
      const int e = e0 + u * W_THREADS;
      long long src = -1;
      dst[u] = e < total ? w_slot<CELL>(e, j0, kk, gk, &src) : -1;
      v[u] = src >= 0 ? rsrc[src] : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int u = 0; u < W_RB; ++u)
      if (dst[u] >= 0) rs[dst[u]] = v[u];
  }

  // -- the steps
  const int row0 = rbi * p.passes * W_ROWS;
  const auto prefetch_hw = [&](const float* hin, int hstride, bool hvec, int n0, int k0,
                               float4 (&pre)[W_QPT]) {
#pragma unroll
    for (int i = 0; i < W_QPT; ++i)
      pre[i] = load_h4(hin, hstride, hvec, n0 + sr, k0 + 4 * (sq + W_SQ * i), nn, kk);
  };
  for (int t = 0; t < p.t; ++t) {
    const float* hin = t == 0 ? p.h0 : p.hbuf + (size_t)((t - 1) & 1) * nn * p.kp;
    const int hstride = t == 0 ? kk : p.kp;
    const bool hvec = t == 0 ? p.h0_vec != 0 : true;
    float* hout = p.hbuf + (size_t)(t & 1) * nn * p.kp;
    const bool last = t + 1 == p.t;

    for (int ps = 0; ps < p.passes; ++ps) {
      const int n0 = row0 + ps * W_ROWS;
      if (n0 >= nn) break;  // block-uniform

      // the epilogue's operands before the product: zx of the thread's
      // columns, and c (LSTM) of its units
      float zv[W_RM][4], sv[W_RM];
#pragma unroll
      for (int r = 0; r < W_RM; ++r) {
        const int n = n0 + rg * W_RM + r;
        const float* zrow = p.zx + ((size_t)t * nn + n) * gk;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = CELL == RNN ? j0 + cg * 4 + c : j0 + cg;
          const bool live = n < nn && j < kk;
          zv[r][c] = live ? zrow[CELL == RNN ? j : c * kk + j] : 0.f;
        }
        const int j = j0 + cg;
        const size_t e = (size_t)n * kk + j;
        sv[r] = 0.f;
        if (CELL == LSTM && n < nn && j < kk) sv[r] = t == 0 ? p.c0[e] : p.ct[e];
      }

      float acc[W_RM][4];
#pragma unroll
      for (int r = 0; r < W_RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

      float4 pre[W_QPT];
      prefetch_hw(hin, hstride, hvec, n0, 0, pre);
      for (int k0 = 0; k0 < p.kr; k0 += KT) {
        __syncthreads();  // the previous chunk is consumed
#pragma unroll
        for (int i = 0; i < W_QPT; ++i) {
          const int q = 4 * (sq + W_SQ * i), kq = k0 + q;   // k in the chunk, in h
          hT[(q + 0) * W_ROWS + sr] = to_r<RT>(pre[i].x);
          hT[(q + 1) * W_ROWS + sr] = kq + 1 < kk ? to_r<RT>(pre[i].y) : 0.f;
          hT[(q + 2) * W_ROWS + sr] = kq + 2 < kk ? to_r<RT>(pre[i].z) : 0.f;
          hT[(q + 3) * W_ROWS + sr] = kq + 3 < kk ? to_r<RT>(pre[i].w) : 0.f;
        }
        __syncthreads();
        if (k0 + KT < p.kr) prefetch_hw(hin, hstride, hvec, n0, k0 + KT, pre);
        const RT* rrow = rs + (size_t)k0 * W_COLS + cg * 4;
        const float* hrow = hT + rg * W_RM;
#pragma unroll 8
        for (int k = 0; k < KT; ++k) {
          const float4 hv = *reinterpret_cast<const float4*>(hrow + k * W_ROWS);
          const float4 rv = load_r4(rrow + (size_t)k * W_COLS);
          const float h4[4] = {hv.x, hv.y, hv.z, hv.w}, r4[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int r = 0; r < W_RM; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(h4[r], r4[c], acc[r][c]);
        }
      }

      // -- the gate epilogue: the thread's 4 rows x its column group, the
      // first design's code as it was (through cell_out it measured 2-8 %
      // slower at N 4100)
#pragma unroll
      for (int r = 0; r < W_RM; ++r) {
        const int n = n0 + rg * W_RM + r;
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
          const float i = sigmoid(__fadd_rn(zv[r][0], acc[r][0]));
          const float g = tanhf(__fadd_rn(zv[r][1], acc[r][1]));
          const float f = sigmoid(__fadd_rn(zv[r][2], acc[r][2]));
          const float o = sigmoid(__fadd_rn(zv[r][3], acc[r][3]));
          const float c2 = __fadd_rn(__fmul_rn(f, sv[r]), __fmul_rn(i, g));
          const float h2 = __fmul_rn(o, tanhf(c2));
          p.ct[(size_t)n * kk + j] = c2;
          if (TRAIN) {
            p.res[0][srow + j] = c2;
            p.res[1][srow + j] = i;
            p.res[2][srow + j] = g;
            p.res[3][srow + j] = f;
            p.res[4][srow + j] = o;
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
  if (smem > (size_t)BLOCK_SMEM_MAX) return -2;
  const DeviceFacts dev = device_facts(device);
  if (!dev.coop) return -2;
  int per_sm = 0;
  const cudaError_t e = blocks_per_sm(kern, threads, smem, device, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const long long slots = (long long)per_sm * dev.sms;
  pl->cb = cb;
  if (cb > slots) return -2;
  const long long rb_max = slots / cb;
  const int rb0 = rb_max < rpass ? (int)rb_max : rpass;
  pl->passes = (rpass + rb0 - 1) / rb0;
  const int rb = (rpass + pl->passes - 1) / pl->passes;
  pl->grid = cb * rb;
  return 0;
}

// The launch plans of the forward kernel's two forms for N x K: the chain
// form's R slice is round_up(K, KT) x G*UNITS values in R's dtype after the h
// chunk; the split form's round_up(K, KT) x COLS f32 values, then the warps'
// partial sums.
template <int CELL, typename RS, bool TRAIN>
int plan_chain(int n, int k, int device, Plan* pl) {
  constexpr int G = CellTraits<CELL>::G, UNITS = CellTraits<CELL>::UNITS;
  const long long kr = (k + KT - 1LL) / KT * KT;
  const long long smem = H_SMEM + kr * G * UNITS * (long long)sizeof(RS);
  if (smem > BLOCK_SMEM_MAX) return -2;
  return coop_plan(reinterpret_cast<const void*>(seq_fwd<CELL, RS, TRAIN>), THREADS,
                   (size_t)smem, (k + UNITS - 1) / UNITS, (n + ROWS - 1) / ROWS, device, pl);
}

template <int CELL, bool TRAIN>
int plan_split(int n, int k, int device, Plan* pl) {
  using Geo = SplitGeo<CELL>;
  constexpr int UNITS = CellTraits<CELL>::UNITS;
  const long long kr = (k + KT - 1LL) / KT * KT;
  const long long smem = H_SMEM + (kr * Geo::COLS + Geo::RED) * 4LL;
  if (smem > BLOCK_SMEM_MAX) return -2;
  return coop_plan(reinterpret_cast<const void*>(seq_fwd_split<CELL, TRAIN>), THREADS,
                   (size_t)smem, (k + UNITS - 1) / UNITS, (n + ROWS - 1) / ROWS, device, pl);
}

template <int CELL, bool TRAIN>
int plan_wide(int n, int k, int device, Plan* pl) {
  constexpr int UNITS = WideTraits<CELL>::UNITS;
  const long long kr = (k + KT - 1LL) / KT * KT;
  const long long smem = W_H_SMEM + kr * W_COLS * 2LL;
  if (smem > BLOCK_SMEM_MAX) return -2;
  return coop_plan(reinterpret_cast<const void*>(seq_fwd_wide<CELL, TRAIN>), W_THREADS,
                   (size_t)smem, (k + UNITS - 1) / UNITS, (n + W_ROWS - 1) / W_ROWS, device, pl);
}

// The forward kernel's form for N x K, its own choice: with f32 R the split
// form where it fits (its slice and partials in a block's shared memory,
// its grid co-resident), else the chain form; with bf16 R the wide form
// where its grid holds at least WideTraits::FILL tenths of a block an SM
// and its row passes cover no more than WideTraits::CHAIN_COST times the
// chain form's rows (the LSTM's two tiles load as many values an FFMA, so
// the form with fewer rows to cover wins), else the chain form.  Both bf16
// forms sum in k order: what the plain version sums, bit for bit.
enum Form { FORM_CHAIN = 0, FORM_SPLIT = 1, FORM_WIDE = 2 };

struct FwdForm {
  Plan pl;
  int form;
  int threads;
};

// the rows a plan's passes cover, padding included
inline long long rows_covered(const Plan& pl, int rows) {
  return (long long)pl.passes * (pl.grid / pl.cb) * rows;
}

template <int CELL, bool TRAIN>
int plan_form(int n, int k, int r_bf16, int device, FwdForm* f) {
  f->form = FORM_CHAIN;
  f->threads = THREADS;
  if (!r_bf16) {
    const int rc = plan_split<CELL, TRAIN>(n, k, device, &f->pl);
    if (rc != -2) {
      if (rc == 0) f->form = FORM_SPLIT;
      return rc;
    }
    return plan_chain<CELL, float, TRAIN>(n, k, device, &f->pl);
  }
  const int rc = plan_chain<CELL, __nv_bfloat16, TRAIN>(n, k, device, &f->pl);
  if (rc != 0 && rc != -2) return rc;
  if constexpr (WideTraits<CELL>::FILL > 0) {
    Plan w;
    const int rw = plan_wide<CELL, TRAIN>(n, k, device, &w);
    if (rw != 0 && rw != -2) return rw;
    const int sms = device_facts(device).sms;
    if (rw == 0 && 10LL * w.grid >= (long long)WideTraits<CELL>::FILL * sms &&
        (rc != 0 || rows_covered(w, W_ROWS) <=
                        WideTraits<CELL>::CHAIN_COST * rows_covered(f->pl, ROWS))) {
      f->pl = w;
      f->form = FORM_WIDE;
      f->threads = W_THREADS;
      return 0;
    }
  }
  return rc;
}

// ... made once a shape: each kernel keeps the plans of its last MEMO
// shapes (a plan or a refusal, -2; other errors are not kept).
constexpr int MEMO = 64;

template <int CELL, bool TRAIN>
int fwd_form(int n, int k, int r_bf16, int device, FwdForm* f) {
  struct Entry {
    int n, k, r_bf16, device, rc;
    FwdForm f;
  };
  static std::mutex mu;
  static Entry memo[MEMO];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = memo[i];
    if (e.n == n && e.k == k && e.r_bf16 == r_bf16 && e.device == device) {
      *f = e.f;
      return e.rc;
    }
  }
  const int rc = plan_form<CELL, TRAIN>(n, k, r_bf16, device, f);
  if (rc == 0 || rc == -2) {
    memo[next] = Entry{n, k, r_bf16, device, rc, *f};
    next = (next + 1) % MEMO;
    if (used < MEMO) ++used;
  }
  return rc;
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
  if (smem > BLOCK_SMEM_MAX) return -2;
  return coop_plan(reinterpret_cast<const void*>(seq_bwd<CELL, RT, RS, BU>), BWD_THREADS,
                   (size_t)smem, (k + BU - 1) / BU, (n + Geo::BROWS - 1) / Geo::BROWS, device,
                   pl);
}

template <typename RT>
int launch(Params p, const FwdForm& f, const void* kern, cudaStream_t st) {
  const Plan& pl = f.pl;
  if ((long long)p.t * pl.grid > 0xffffffffLL) return -2;  // the barrier's count
  p.kp = (p.k + 3) / 4 * 4;
  p.kr = (p.k + KT - 1) / KT * KT;
  p.cb = pl.cb;
  p.passes = pl.passes;
  p.h0_vec = p.k % 4 == 0 && reinterpret_cast<uintptr_t>(p.h0) % 16 == 0;
  p.r_vec = p.k % 4 == 0 && reinterpret_cast<uintptr_t>(p.r) % (4 * sizeof(RT)) == 0;
  // (coop_plan raised the kernel's shared-memory limit to the plan's)
  cudaError_t e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kern, dim3(pl.grid), dim3(f.threads), args, pl.smem, st);
  cudaGetLastError();  // clear the sticky launch error, returned below
  return (int)e;
}

// Launches the forward kernel of its form for p's shape and sets *form to
// the form launched.
template <int CELL, bool TRAIN>
int dispatch(const Params& p, int r_bf16, int device, void* stream, int* form) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  FwdForm f;
  int rc = fwd_form<CELL, TRAIN>(p.n, p.k, r_bf16, device, &f);
  if (rc) return rc;
  if (r_bf16) {
    const void* kern = reinterpret_cast<const void*>(seq_fwd<CELL, __nv_bfloat16, TRAIN>);
    if constexpr (WideTraits<CELL>::FILL > 0)
      if (f.form == FORM_WIDE) kern = reinterpret_cast<const void*>(seq_fwd_wide<CELL, TRAIN>);
    rc = launch<__nv_bfloat16>(p, f, kern, st);
  } else
    rc = launch<float>(
        p, f,
        f.form == FORM_SPLIT ? reinterpret_cast<const void*>(seq_fwd_split<CELL, TRAIN>)
                             : reinterpret_cast<const void*>(seq_fwd<CELL, float, TRAIN>),
        st);
  if (rc == 0) *form = f.form;
  return rc;
}

// The form of both kernels of a cell (the train form's, where it has one;
// the two share their geometry), or the first refusal.
template <int CELL>
int fits(int n, int k, int r_bf16, int device, FwdForm* f) {
  int rc = fwd_form<CELL, false>(n, k, r_bf16, device, f);
  if (rc == 0 && CELL != RNN) rc = fwd_form<CELL, true>(n, k, r_bf16, device, f);
  return rc;
}

int fwd_form_any(int gates, int n, int k, int r_bf16, int device, FwdForm* f) {
  switch (gates) {
    case 4: return fits<LSTM>(n, k, r_bf16, device, f);
    case 3: return fits<GRU>(n, k, r_bf16, device, f);
    case 1: return fits<RNN>(n, k, r_bf16, device, f);
    default: return -1;
  }
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
// form.  *form is set to the form launched (0 chain, 1 split, 2 wide, as
// xsmm_rnn_seq_form reports it).  Nothing synchronises.  T, N, K >= 1.
extern "C" int xsmm_lstm_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                             const float* c0, float* hs, float* ht, float* ct, float* cs,
                             float* is, float* gs, float* fs, float* os, float* hbuf,
                             unsigned* bar, int t, int n, int k, int* form, int device,
                             void* stream) {
  Params p{zx, r, h0, c0, hs, ht, ct, {cs, is, gs, fs, os}, hbuf, bar, t, n, k,
           0, 0, 0, 0, 0, 0};
  return cs ? dispatch<LSTM, true>(p, r_bf16, device, stream, form)
            : dispatch<LSTM, false>(p, r_bf16, device, stream, form);
}

extern "C" int xsmm_gru_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                            float* hs, float* ht, float* ris, float* zis, float* gis,
                            float* zrgs, float* hbuf, unsigned* bar, int t, int n, int k,
                            int* form, int device, void* stream) {
  Params p{zx, r, h0, nullptr, hs, ht, nullptr, {ris, zis, gis, zrgs, nullptr}, hbuf, bar,
           t, n, k, 0, 0, 0, 0, 0, 0};
  return ris ? dispatch<GRU, true>(p, r_bf16, device, stream, form)
             : dispatch<GRU, false>(p, r_bf16, device, stream, form);
}

extern "C" int xsmm_rnn_seq(const float* zx, const void* r, int r_bf16, const float* h0,
                            float* hs, float* ht, int act, float* hbuf, unsigned* bar, int t,
                            int n, int k, int* form, int device, void* stream) {
  if (act < 0 || act > 2) return -1;
  Params p{zx, r, h0, nullptr, hs, ht, nullptr, {nullptr, nullptr, nullptr, nullptr, nullptr},
           hbuf, bar, t, n, k, 0, 0, 0, 0, act, 0};
  return dispatch<RNN, false>(p, r_bf16, device, stream, form);
}

// 1 if the kernel of a cell with `gates` gates (4 LSTM, 3 GRU, 1 RNN) and R of
// `r_itemsize` bytes (4 f32, 2 bf16) runs N x K on device `device`, in both
// forms; 0 if the shape is outside its envelope; -1 for gates or itemsize it
// does not take; else a cudaError_t.
extern "C" int xsmm_rnn_seq_fits(int n, int k, int gates, int r_itemsize, int device) {
  if (r_itemsize != 2 && r_itemsize != 4) return -1;
  if (n < 1 || k < 1) return 0;
  cudaSetDevice(device);
  FwdForm f;
  const int rc = fwd_form_any(gates, n, k, r_itemsize == 2, device, &f);
  return rc == 0 ? 1 : rc == -2 ? 0 : rc;
}

// The forward kernel's launch plan for N x K, as the entry points make it:
// out[0] blocks, out[1] column blocks, out[2] ROWS-row passes a block,
// out[3] the form (0 chain, 1 split, 2 wide), out[4] the SMs of the card,
// out[5] the rows of a pass.  0, or as xsmm_rnn_seq_fits' refusals
// (-2: outside the envelope).  `stream` is not used.
extern "C" int xsmm_rnn_seq_form(int n, int k, int gates, int r_itemsize, int* out, int device,
                                 void*) {
  if (r_itemsize != 2 && r_itemsize != 4) return -1;
  if (n < 1 || k < 1) return -2;
  cudaSetDevice(device);
  FwdForm f;
  const int rc = fwd_form_any(gates, n, k, r_itemsize == 2, device, &f);
  if (rc) return rc;
  out[0] = f.pl.grid; out[1] = f.pl.cb; out[2] = f.pl.passes; out[3] = f.form;
  out[4] = device_facts(device).sms; out[5] = f.form == FORM_WIDE ? W_ROWS : ROWS;
  return 0;
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
