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
// Design: persistent blocks that keep device memory busy.  What it does
// about the bound is to read each B element and write each C element once,
// coalesced, with the next tiles' loads in flight while a tile is summed:
//   * The grid is as many blocks as fit the SMs at once (one a SM at the
//     PyFR sizes).  The items are the column tiles, in order; where the
//     last round would leave half the blocks idle, its tiles are cut into
//     slices of rows (up to TAIL_SPLIT a tile).  The blocks take items in
//     order from a counter in device memory (atomicAdd), so an SM that runs
//     faster takes more, and the SMs work on neighbouring tiles.  A tile
//     is CT = 32 * CPT columns: CPT = 4 (float4) with one B plane, 2
//     (float2) with two, so one stage of a 150-deep B is 76.8 KB either way;
//     where two such stages do not fit (K above ~220), the narrow tile of
//     one column a lane.
//   * A producer warp takes the block's items and announces each (an `ann`
//     mbarrier a slot), and fills a ring of 2-4 stages of B tiles in shared
//     memory, each stage guarded by a `full` and an `empty` mbarrier: "tma"
//     issues the boxes of a 2-D tensor map of each [K, N] plane (rows of at
//     most 256, columns past N read as zeros; needs N % 4 == 0 and planes
//     on 16 bytes: a box must start on 16 bytes); on "cp_async" CP_WARPS
//     producer warps copy rows in turn, 4 bytes a lane, and count them on
//     `full` (cp.async.mbarrier.arrive), for any N and alignment.  Where two
//     stages do not fit, "unstaged" reads B from device memory (the
//     producer then only takes items).
//   * The operator (row_ptr and one 8- or 16-byte record {col, vh, vl} a
//     term) is copied to shared memory once a block ("shared"), read as
//     broadcasts; above the caller's budget it stays in device memory
//     ("global").  The route is picked by spgemm_kernels.pick_route; this
//     file refuses (-2) a route it cannot run.
//   * RG = 24 consumer warps share the rows of a tile: warp w sums rows w,
//     w + RG, ...; a lane holds CPT neighbouring columns, so a term is one
//     vector load of B from shared memory and CPT (f64: 2 CPT) independent
//     sums.  C leaves from registers, one 16- or 8-byte store a lane where
//     N and the C planes are aligned to it; elsewhere (and in a ragged
//     last tile, masked) the row goes through a buffer of the warp in
//     shared memory, so that each store writes 32 neighbouring floats.
//     C_in's copies and cp.async's take 32 neighbouring floats an
//     instruction too.
//   * acc: with the wide tile, the C_in tile goes into each stage with B
//     where two such stages fit (the smaller PyFR operators; TMA where it
//     addresses C_in, else cp.async); else each warp keeps CIN_AHEAD - 1 of
//     its next rows of
//     C_in in flight (cp.async into a ring of its own in shared memory,
//     into the block's next item), so C_in's latency hides behind the rows
//     before.
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

#include <cuda.h>  // CUtensorMap and its enums (the CUDA driver API's
                   // entry point is taken through the runtime)
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <functional>
#include <mutex>
#include <unordered_map>

#include "tma.cuh"

namespace {

constexpr int RG = 24;             // consumer warps a block
constexpr int CP_WARPS = 4;        // producer warps of the cp.async ring
constexpr int CIN_AHEAD = 4;       // acc: rows of C_in a warp has in flight
constexpr int TAIL_SPLIT = 8;      // row slices a tile of a short last round
constexpr int CPT_ONE = 4;         // columns a lane with one B plane
constexpr int CPT_TWO = 2;         // columns a lane with two B planes
constexpr int MAX_STAGES = 4;      // stages of the ring at most
constexpr int MAX_BOX_ROWS = 256;  // rows of a TMA box at most
constexpr int BAR_BYTES = 4 * MAX_STAGES * 8;  // full, empty, ann, item_of
constexpr int SCHED_SLOTS = 4096;  // pairs of item counters a device
constexpr int MAX_DEVICES = 64;

// route codes of ops/spgemm_kernels.py (STAGINGS, STRUCTURES)
enum Staging { ST_TMA = 0, ST_CP_ASYNC = 1, ST_UNSTAGED = 2 };
enum Structure { SR_SHARED = 0, SR_GLOBAL = 1 };

// the tensor maps of the B planes and, where staged, the C_in planes (TMA
// route; unused ones left zero)
struct Maps {
  CUtensorMap b0, b1, c0, c1;
};

// where a launch stages B: stage planes are kp = nbox * box_rows rows deep
struct Geom {
  int kp, box_rows, nbox, stages;
  int mp, mbox_rows, nmbox;  // CSTG: the C_in planes' rows, the same way
};

// 4-byte words of the operator in shared memory: row_ptr (rounded up to
// 16 bytes), then one record a term
__host__ __device__ constexpr long long rp_words(int m) {
  return ((long long)m + 1 + 3) / 4 * 4;
}
__host__ __device__ constexpr int term_words(bool f64) { return f64 ? 4 : 2; }

// bytes of the consumers' buffers beside the ring: acc, the C_in rings (a
// warp's CIN_AHEAD rows of each C_in plane at its tile's width); unroll, a
// row of C a warp, through which rows off 16 bytes are stored
__host__ __device__ constexpr int cbuf_bytes(bool acc, bool clo, int cpt) {
  return (acc ? RG * CIN_AHEAD * (clo ? 2 : 1) : RG) * 32 * cpt * 4;
}

template <int V>
__device__ __forceinline__ void vload(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

template <int V>
__device__ __forceinline__ void vload_global(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x, v[1] = x.y;
  }
}

template <int V>
__device__ __forceinline__ void vstore(float* p, const float (&v)[V]) {
  if constexpr (V == 1)
    *p = v[0];
  else if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until at most n of the thread's cp.async groups are pending (n >= N: N)
template <int N>
__device__ __forceinline__ void wait_at_most(long long n) {
  if constexpr (N == 0) {
    __pipeline_wait_prior(0);
  } else {
    if (n >= N)
      __pipeline_wait_prior(N);
    else
      wait_at_most<N - 1>(n);
  }
}

// STAGED: B from the ring (TMA or cp.async by warp RG); else from device
// memory.  SHS: the operator from shared memory; else from device memory.
// CPT: columns a lane (the tile is 32 * CPT wide).  CSTG (acc): the C_in
// tile staged with B in each stage; else through the warps' rings.
// Items: q < whole is column tile q, all rows; above, slice (q - whole) %
// split of the rows of tile whole + (q - whole) / split; `items` in all.
// Block b takes item b, then items in order from gridDim.x + the counter
// sched[0]; the last block done sets sched[0] and sched[1] back to 0 for
// the next launch.
template <bool F64, bool BLO, bool CLO, bool ACC, bool STAGED, bool SHS,
          int CPT, bool CSTG = false>
__global__ void __launch_bounds__((RG + CP_WARPS) * 32, 1)
spgemm_kernel(const __grid_constant__ Maps maps, const int* __restrict__ row_ptr,
              const int* __restrict__ cols, const float* __restrict__ vh,
              const float* __restrict__ vl, const float* __restrict__ bh,
              const float* __restrict__ bl, const float* __restrict__ c0_in,
              const float* __restrict__ c1_in, float* __restrict__ c0,
              float* __restrict__ c1, int M, int K, long long N, int nnz,
              Geom geo, bool tma, bool vec_c, long long whole, int split,
              long long items, unsigned long long* __restrict__ sched) {
  constexpr int CT = 32 * CPT;
  constexpr int PLANES = BLO ? 2 : 1;
  constexpr int TW = term_words(F64);
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // item q: its first column, and its rows [r0, r1)
  auto item = [&](long long q, long long& n0, int& r0, int& r1) {
    if (q < whole) {
      n0 = q * CT, r0 = 0, r1 = M;
    } else {
      const long long j = q - whole;
      const int sl = (int)(j % split);
      n0 = (whole + j / split) * CT;
      r0 = (int)((long long)sl * M / split);
      r1 = (int)((long long)(sl + 1) * M / split);
    }
  };
  // slots: the ring's stages, or (unstaged) two slots of item numbers
  const int S = STAGED ? geo.stages : 2;
  constexpr int CPL = CLO ? 2 : 1;  // C_in planes
  const int plane = geo.kp * CT;  // floats of one plane of a stage
  const int mplane = CSTG ? geo.mp * CT : 0;  // of one staged C_in plane
  const int stage = PLANES * plane + CPL * mplane;
  float* ring = reinterpret_cast<float*>(smem);
  float* cbuf = ring + (STAGED ? (size_t)S * stage : 0);
  int* terms = reinterpret_cast<int*>(cbuf) +
               (CSTG ? 0 : cbuf_bytes(ACC, CLO, CPT) / 4);
  int* rp = terms + (SHS ? (long long)nnz * TW : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(rp + (SHS ? rp_words(M) : 0));
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* ann = empty + MAX_STAGES;  // a slot's item number is written
  long long* item_of = reinterpret_cast<long long*>(ann + MAX_STAGES);

  // producer warps: one, or CP_WARPS on the cp.async ring (the LSU of one
  // SM sub-partition alone does not keep device memory busy)
  const int P = STAGED && !tma ? CP_WARPS : 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      if (STAGED) mbar_init(&full[s], tma ? 1 : 32 * P);
      mbar_init(&empty[s], RG);
      mbar_init(&ann[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the number of the block's i-th item (-1: none left)
  auto announced = [&](int i) -> long long {
    mbar_wait(&ann[i % S], (unsigned)(i / S) & 1);
    return item_of[i % S];
  };
  // -- the producer warps: the block's i-th item into slot i % S, once the
  // consumers have released the slot's previous item: producer warp 0 takes
  // its number and announces it, then (staged) each producer warp copies
  // its share of the B tiles
  if (warp >= RG) {
    const int pw = warp - RG;
    for (int i = 0;; ++i) {
      const int slot = i % S;
      if (i >= S) mbar_wait(&empty[slot], (unsigned)(i / S - 1) & 1);
      long long q = 0;
      if (pw > 0) {
        q = announced(i);
      } else if (lane == 0) {
        // the first item is the block's own; the rest come from the counter
        q = i == 0 ? (long long)blockIdx.x
                   : (long long)gridDim.x +
                         (long long)atomicAdd(&sched[0], 1ULL);
        if (q >= items) q = -1;
        item_of[slot] = q;
        mbar_arrive(&ann[slot]);
      }
      q = __shfl_sync(0xffffffffu, q, 0);
      if (q < 0) break;
      if constexpr (STAGED) {
        long long n0;
        int r0, r1;
        item(q, n0, r0, r1);
        float* dst = ring + slot * stage;
        if (tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[slot], (unsigned)stage * 4);
            for (int b = 0; b < geo.nbox; ++b) {
              tma_load_2d(dst + b * geo.box_rows * CT, &maps.b0, &full[slot],
                          (int)n0, b * geo.box_rows);
              if constexpr (BLO)
                tma_load_2d(dst + plane + b * geo.box_rows * CT, &maps.b1,
                            &full[slot], (int)n0, b * geo.box_rows);
            }
            if constexpr (CSTG) {
              float* dc = dst + PLANES * plane;
              for (int b = 0; b < geo.nmbox; ++b) {
                tma_load_2d(dc + b * geo.mbox_rows * CT, &maps.c0, &full[slot],
                            (int)n0, b * geo.mbox_rows);
                if constexpr (CLO)
                  tma_load_2d(dc + mplane + b * geo.mbox_rows * CT, &maps.c1,
                              &full[slot], (int)n0, b * geo.mbox_rows);
              }
            }
          }
        } else {
          // rows pw, pw + P, ..., 32 neighbouring floats a copy
          // instruction; columns past N repeat column N - 1
          const bool inside = n0 + CT <= N;
          const float* s0 = bh + n0 + pw * N;
          const float* s1 = (BLO ? bl : bh) + n0 + pw * N;
          for (int kk = pw; kk < K; kk += P, s0 += P * N, s1 += P * N) {
            float* d = dst + kk * CT;
#pragma unroll
            for (int jj = 0; jj < CPT; ++jj) {
              const int j = jj * 32 + lane;
              const long long o = inside || n0 + j < N ? j : N - 1 - n0;
              __pipeline_memcpy_async(d + j, s0 + o, 4);
              if constexpr (BLO)
                __pipeline_memcpy_async(d + plane + j, s1 + o, 4);
            }
          }
          if constexpr (CSTG) {  // the C_in tile, rows the same way
            float* dc = dst + PLANES * plane;
            const float* q0 = c0_in + n0 + pw * N;
            const float* q1 = (CLO ? c1_in : c0_in) + n0 + pw * N;
            for (int r = pw; r < M; r += P, q0 += P * N, q1 += P * N) {
              float* d = dc + r * CT;
#pragma unroll
              for (int jj = 0; jj < CPT; ++jj) {
                const int j = jj * 32 + lane;
                const long long o = inside || n0 + j < N ? j : N - 1 - n0;
                __pipeline_memcpy_async(d + j, q0 + o, 4);
                if constexpr (CLO)
                  __pipeline_memcpy_async(d + mplane + j, q1 + o, 4);
              }
            }
          }
          cp_async_arrive(&full[slot]);
        }
      }
    }
    if (pw == 0 && lane == 0) {  // done taking items; the last block
                                 // resets the counter
      __threadfence();
      if (atomicAdd(&sched[1], 1ULL) == gridDim.x - 1ULL) {
        atomicExch(&sched[0], 0ULL);
        atomicExch(&sched[1], 0ULL);
      }
    }
    if (STAGED && !tma) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // -- the consumers
  // acc: C_in of the warp's rows goes through a ring of CIN_AHEAD rows in
  // shared memory (cp.async: a lane's own columns where the row is on 16
  // bytes, else 32 neighbouring floats a copy; one commit group a row),
  // issued up to CIN_AHEAD - 1 rows ahead of the row being summed,
  // into the block's next item at most (a later one may wait for this
  // warp's release); the cursor: item ordinal ci (number cq), row cr of
  // [.., cr1), column cn0
  float* wbuf = cbuf + (size_t)warp * CIN_AHEAD * CPL * CT;
  long long kis = 0, kc = 0;  // rows issued, rows consumed
  int ci = 0, cr = 0, cr1 = 0;
  long long cq = -1, cn0 = 0;
  auto cin_open = [&](int i) {
    ci = i, cq = announced(i);
    if (cq >= 0) {
      int r0;
      item(cq, cn0, r0, cr1);
      cr = r0 + warp;
    }
  };
  auto cin_fill = [&](int ilim) {
    while (kis - kc < CIN_AHEAD) {
      while (cq >= 0 && cr >= cr1) {
        if (ci + 1 > ilim) return;
        cin_open(ci + 1);
      }
      if (cq < 0) return;
      const long long orow = (long long)cr * N;
      float* dst = wbuf + (int)(kis % CIN_AHEAD) * CPL * CT;
      if (vec_c && cn0 + CT <= N) {  // the lane's CPT columns, one copy
        const long long nk = cn0 + lane * CPT;
        __pipeline_memcpy_async(dst + lane * CPT, c0_in + orow + nk, CPT * 4);
        if constexpr (CLO)
          __pipeline_memcpy_async(dst + CT + lane * CPT, c1_in + orow + nk,
                                  CPT * 4);
      } else {  // column 32 j + lane, 32 neighbouring floats a copy
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const long long n0j = cn0 + 32 * j + lane;
          const long long n = n0j < N ? n0j : N - 1;
          __pipeline_memcpy_async(dst + 32 * j + lane, c0_in + orow + n, 4);
          if constexpr (CLO)
            __pipeline_memcpy_async(dst + CT + 32 * j + lane, c1_in + orow + n,
                                    4);
        }
      }
      __pipeline_commit();
      cr += RG, ++kis;
    }
  };
  if constexpr (ACC && !CSTG) {
    cin_open(0);
    cin_fill(1);
  }
  // the operator to shared memory, once
  if constexpr (SHS) {
    for (int i = threadIdx.x; i <= M; i += RG * 32) rp[i] = row_ptr[i];
    for (int p = threadIdx.x; p < nnz; p += RG * 32) {
      terms[p * TW] = cols[p];
      terms[p * TW + 1] = __float_as_int(vh[p]);
      if constexpr (F64) terms[p * TW + 2] = __float_as_int(vl[p]);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(RG * 32) : "memory");
  }
  auto term = [&](int p, int& c, float& h, float& l) {
    if constexpr (SHS && F64) {
      const int4 t = *reinterpret_cast<const int4*>(terms + p * TW);
      c = t.x, h = __int_as_float(t.y), l = __int_as_float(t.z);
    } else if constexpr (SHS) {
      const int2 t = *reinterpret_cast<const int2*>(terms + p * TW);
      c = t.x, h = __int_as_float(t.y), l = 0.f;
    } else {
      c = __ldg(cols + p), h = __ldg(vh + p), l = F64 ? __ldg(vl + p) : 0.f;
    }
  };

  for (int i = 0;; ++i) {
    const long long q = announced(i);
    if (q < 0) break;
    const int slot = i % S;
    long long n0;
    int r0, r1;
    item(q, n0, r0, r1);
    const long long nb = n0 + lane * CPT;  // the lane's first column
    long long ncol[CPT];  // the lane's columns, clamped into [0, N)
#pragma unroll
    for (int j = 0; j < CPT; ++j) ncol[j] = nb + j < N ? nb + j : N - 1;
    const bool whole_c = vec_c && n0 + CT <= N;  // vector C access
    // unstaged: vector B loads where N and the planes allow them
    const bool vec_b =
        N % CPT == 0 &&
        !(((uintptr_t)bh | (uintptr_t)(BLO ? bl : bh)) & (CPT * 4 - 1));
    // a row of C through the warp's row buffer `ob` (CT floats): in as one
    // vector a lane, out at columns n0 + 32 q + lane (q < CPT), so that a
    // store is 32 neighbouring floats
    auto store_cols = [&](float* row, const float (&v)[CPT], float* ob) {
      vstore(ob + lane * CPT, v);
      __syncwarp();
#pragma unroll
      for (int qq = 0; qq < CPT; ++qq) {
        const long long n = n0 + 32 * qq + lane;
        if (n < N) row[n] = ob[32 * qq + lane];
      }
      __syncwarp();
    };
    const float* t0 = ring + slot * stage + lane * CPT;
    if constexpr (STAGED) mbar_wait(&full[slot], (unsigned)(i / S) & 1);

    // the B values of column c at this lane's columns
    auto bvals = [&](int c, float (&vh_)[CPT], float (&vl_)[CPT]) {
      if constexpr (STAGED) {
        vload(t0 + c * CT, vh_);
        if constexpr (BLO) vload(t0 + plane + c * CT, vl_);
      } else if (vec_b && nb + CPT <= N) {
        vload_global(bh + (long long)c * N + nb, vh_);
        if constexpr (BLO) vload_global(bl + (long long)c * N + nb, vl_);
      } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          vh_[j] = __ldg(bh + (long long)c * N + ncol[j]);
          if constexpr (BLO) vl_[j] = __ldg(bl + (long long)c * N + ncol[j]);
        }
      }
    };

    for (int r = r0 + warp; r < r1; r += RG) {
      const int s = SHS ? rp[r] : __ldg(row_ptr + r);
      const int e = SHS ? rp[r + 1] : __ldg(row_ptr + r + 1);
      const long long orow = (long long)r * N;
      float ci0[CPT], ci1[CPT];
      if constexpr (CSTG) {
        const float* src = t0 + PLANES * plane + r * CT;
        vload(src, ci0);
        if constexpr (CLO) vload(src + mplane, ci1);
      } else if constexpr (ACC) {
        cin_fill(i + 1);
        wait_at_most<CIN_AHEAD - 1>(kis - kc - 1);  // row kc has landed
        __syncwarp();  // and the other lanes' copies of it
        const float* src =
            wbuf + (int)(kc % CIN_AHEAD) * CPL * CT + lane * CPT;
        vload(src, ci0);
        if constexpr (CLO) vload(src + CT, ci1);
        ++kc;
      }
      float hi[CPT], lo[CPT];
      if (s == e) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          hi[j] = ACC ? ci0[j] : 0.f;
          lo[j] = ACC && CLO ? ci1[j] : 0.f;
        }
      } else {
        {
          int c;
          float h, l, bv[CPT], bw[CPT];
          term(s, c, h, l);
          bvals(c, bv, bw);
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            hi[j] = __fmul_rn(h, bv[j]);
            if constexpr (F64) {
              lo[j] = __fmul_rn(l, bv[j]);
              if constexpr (BLO) lo[j] = __fadd_rn(lo[j], __fmul_rn(h, bw[j]));
            }
          }
        }
#pragma unroll 4
        for (int p = s + 1; p < e; ++p) {
          int c;
          float h, l, bv[CPT], bw[CPT];
          term(p, c, h, l);
          bvals(c, bv, bw);
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            hi[j] = __fadd_rn(hi[j], __fmul_rn(h, bv[j]));
            if constexpr (F64) {
              if constexpr (BLO)
                lo[j] = __fadd_rn(lo[j], __fadd_rn(__fmul_rn(h, bw[j]),
                                                   __fmul_rn(l, bv[j])));
              else
                lo[j] = __fadd_rn(lo[j], __fmul_rn(l, bv[j]));
            }
          }
        }
        // the outputs, in place of the sums
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          if constexpr (!F64 || CLO) {
            if constexpr (ACC) {
              hi[j] = __fadd_rn(ci0[j], hi[j]);
              if constexpr (CLO) lo[j] = __fadd_rn(ci1[j], lo[j]);
            }
          } else {
            const float sum = __fadd_rn(hi[j], lo[j]);
            hi[j] = ACC ? __fadd_rn(ci0[j], sum) : sum;
          }
        }
      }
      // -- the store
      if (whole_c) {
        vstore(c0 + orow + nb, hi);
        if constexpr (CLO) vstore(c1 + orow + nb, lo);
      } else {
        // the row buffer: the unroll kernels' own, else the C_in row just
        // read (its ring slot, or its rows of the staged tile)
        float* ob;
        if constexpr (CSTG)
          ob = ring + slot * stage + PLANES * plane + r * CT;
        else if constexpr (ACC)
          ob = wbuf + (int)((kc - 1) % CIN_AHEAD) * CPL * CT;
        else
          ob = cbuf + (size_t)warp * CT;
        store_cols(c0 + orow, hi, ob);
        if constexpr (CLO) store_cols(c1 + orow, lo, ob);
      }
    }
    // -- the slot back to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
}

// the card's SM count and the shared memory a block can opt into, once a
// device
struct DevInfo {
  int sms, smem_optin;
};

DevInfo dev_info(int device) {
  static DevInfo info[MAX_DEVICES] = {};
  if (info[device].sms == 0) {
    DevInfo d = {};
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&d.smem_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    info[device] = d;
  }
  return info[device];
}

// A launch's item counters {next item, blocks done} on `device` for
// `stream`: a pair of the stream's own (the launches on one stream run one
// after another, and each leaves its pair at zero), from a pool zeroed
// once a device; beyond SCHED_SLOTS streams, streams share pairs by hash.
unsigned long long* sched_counters(int device, cudaStream_t stream) {
  static std::mutex lock;
  static unsigned long long* pool[MAX_DEVICES] = {};
  static std::unordered_map<cudaStream_t, int> slot[MAX_DEVICES];
  const std::lock_guard<std::mutex> hold(lock);
  if (pool[device] == nullptr) {
    unsigned long long* p = nullptr;
    const size_t bytes = 2 * SCHED_SLOTS * sizeof(unsigned long long);
    if (cudaMalloc(&p, bytes) != cudaSuccess) return nullptr;
    if (cudaMemset(p, 0, bytes) != cudaSuccess) {
      cudaFree(p);
      return nullptr;
    }
    pool[device] = p;
  }
  std::unordered_map<cudaStream_t, int>& mine = slot[device];
  const auto it = mine.find(stream);
  int i;
  if (it != mine.end()) {
    i = it->second;
  } else if (mine.size() < (size_t)SCHED_SLOTS) {
    i = (int)mine.size();
    mine.emplace(stream, i);
  } else {
    i = (int)(std::hash<cudaStream_t>()(stream) % SCHED_SLOTS);
  }
  return pool[device] + 2 * i;
}

// The map of an f32 plane [K][N] at p, boxes of box_rows x CT; elements
// past the edges read as zeros
bool plane_map(CUtensorMap* map, const float* p, int k, long long n, int ct,
               int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t box[2] = {(cuuint32_t)ct, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool F64, bool BLO, bool CLO, bool ACC, bool STAGED, bool SHS,
          int CPT, bool CSTG = false>
int launch_kernel(const Maps& maps, const int* row_ptr, const int* cols,
                  const float* vh, const float* vl, const float* bh,
                  const float* bl, const float* c0_in, const float* c1_in,
                  float* c0, float* c1, int m, int k, long long n, int nnz,
                  const Geom& geo, bool tma, bool vec_c, int smem, int device,
                  cudaStream_t st) {
  constexpr int CT = 32 * CPT;
  auto kern = spgemm_kernel<F64, BLO, CLO, ACC, STAGED, SHS, CPT, CSTG>;
  const int threads = (RG + (STAGED && !tma ? CP_WARPS : 1)) * 32;
  // once an instance and device: the opt-in shared memory; the blocks an SM
  // at the last shared-memory size asked for
  static bool opted[MAX_DEVICES] = {};
  static int last_smem[MAX_DEVICES], last_per_sm[MAX_DEVICES];
  const DevInfo info = dev_info(device);
  if (!opted[device]) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         info.smem_optin);
    opted[device] = true;
    last_per_sm[device] = 0;
  }
  if (last_per_sm[device] == 0 || last_smem[device] != smem) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                  smem);
    last_smem[device] = smem;
    last_per_sm[device] = per_sm > 0 ? per_sm : 1;
  }
  const long long tiles = (n + CT - 1) / CT;
  const long long sms_grid = (long long)last_per_sm[device] * info.sms;
  // a last round that would leave half the blocks idle or more is cut into
  // row slices, so that the blocks share it
  const long long rounds = (tiles + sms_grid - 1) / sms_grid;
  const long long last = tiles - (rounds - 1) * sms_grid;
  long long split = 1;
  if (2 * last <= sms_grid) {
    split = sms_grid / last;
    if (split > TAIL_SPLIT) split = TAIL_SPLIT;
    if (split > m) split = m;
  }
  const long long whole = split > 1 ? tiles - last : tiles;
  const long long items = whole + (tiles - whole) * split;
  const long long grid = items < sms_grid ? items : sms_grid;
  unsigned long long* sched = sched_counters(device, st);
  if (sched == nullptr) return (int)cudaErrorMemoryAllocation;
  kern<<<dim3((unsigned)grid), dim3(threads), smem, st>>>(
      maps, row_ptr, cols, vh, vl, bh, bl, c0_in, c1_in, c0, c1, m, k, n, nnz,
      geo, tma, vec_c, whole, (int)split, items, sched);
  return (int)cudaGetLastError();
}

// Whether TMA addresses [rows, n] planes at p and q: a box's start (and
// so each row) on 16 bytes
bool two_d(long long n, const float* p, const float* q) {
  return n % 4 == 0 && n <= INT_MAX && !(((uintptr_t)p | (uintptr_t)q) & 15);
}

// The shared memory of a launch on route (staging, structure), the one
// check of whether that route fits (the launches and xsmm_spgemm_fits ask
// it): -2 where it does not (a staged route without room for two stages of
// even the narrow tile beside the structure, an operator beyond shared
// memory).  A staged route takes the wide tile (`wide` columns a lane)
// where two of its stages fit beside the acc kernels' C_in rings, else the
// narrow one (a column a lane); `geo` and `cpt` say which.
int plan(bool f64, int planes, int wide, bool acc, bool clo, int m, int k,
         int nnz, int staging, int structure, const DevInfo& info, Geom& geo,
         int& cpt, long long& smem) {
  if (structure != SR_SHARED && structure != SR_GLOBAL) return -2;
  const long long sbytes =
      structure == SR_SHARED
          ? 4 * ((long long)nnz * term_words(f64) + rp_words(m)) : 0;
  geo = Geom{};
  cpt = wide;
  smem = sbytes + cbuf_bytes(acc, clo, wide) + BAR_BYTES;
  if (staging == ST_TMA || staging == ST_CP_ASYNC) {
    if (k <= 0) return -2;
    geo.nbox = (k + MAX_BOX_ROWS - 1) / MAX_BOX_ROWS;
    geo.box_rows = (k + geo.nbox - 1) / geo.nbox;
    geo.kp = geo.nbox * geo.box_rows;
    const long long room = info.smem_optin - sbytes - BAR_BYTES;
    long long stage = 4LL * planes * geo.kp * 32 * cpt;
    if (2 * stage + cbuf_bytes(acc, clo, cpt) > room)
      cpt = 1, stage = 4LL * planes * geo.kp * 32;
    const long long left = room - cbuf_bytes(acc, clo, cpt);
    if (2 * stage > left) return -2;
    geo.stages = left / stage > MAX_STAGES ? MAX_STAGES : (int)(left / stage);
    smem =
        geo.stages * stage + cbuf_bytes(acc, clo, cpt) + sbytes + BAR_BYTES;
  } else if (staging != ST_UNSTAGED) {
    return -2;
  }
  return smem > info.smem_optin ? -2 : 0;
}

// The route the caller named (ops/spgemm_kernels.py pick_route), checked
// by plan() and, for TMA, against the planes' alignment: -2 where it
// cannot run, nothing launched.
template <bool F64, bool BLO, bool CLO, bool ACC>
int launch(const int* row_ptr, const int* cols, const float* vh,
           const float* vl, const float* bh, const float* bl,
           const float* c0_in, const float* c1_in, float* c0, float* c1,
           int m, int k, long long n, int nnz, int staging, int structure,
           int device, void* stream) {
  constexpr int WIDE = BLO ? CPT_TWO : CPT_ONE;
  constexpr int PLANES = BLO ? 2 : 1;
  if (device < 0 || device >= MAX_DEVICES) return -2;
  cudaSetDevice(device);
  const DevInfo info = dev_info(device);
  Geom geo;
  int cpt;
  long long smem;
  if (plan(F64, PLANES, WIDE, ACC, CLO, m, k, nnz, staging, structure, info,
           geo, cpt, smem))
    return -2;
  const bool shs = structure == SR_SHARED;
  const long long sbytes =
      shs ? 4 * ((long long)nnz * term_words(F64) + rp_words(m)) : 0;
  Maps maps = {};
  bool cstg = false;
  const bool tma = staging == ST_TMA;
  if (staging != ST_UNSTAGED) {
    if (tma && (!two_d(n, bh, BLO ? bl : bh) ||
                !plane_map(&maps.b0, bh, k, n, 32 * cpt, geo.box_rows) ||
                (BLO && !plane_map(&maps.b1, bl, k, n, 32 * cpt,
                                   geo.box_rows))))
      return -2;
    // acc on the wide tile: the C_in tile staged with B where two such
    // stages fit (and, for TMA, where it can address the C_in planes)
    const long long room = info.smem_optin - sbytes - BAR_BYTES;
    geo.nmbox = (m + MAX_BOX_ROWS - 1) / MAX_BOX_ROWS;
    geo.mbox_rows = (m + geo.nmbox - 1) / geo.nmbox;
    geo.mp = geo.nmbox * geo.mbox_rows;
    const long long cstage =
        4LL * (PLANES * geo.kp + (CLO ? 2 : 1) * geo.mp) * 32 * cpt;
    cstg = ACC && cpt == WIDE && 2 * cstage <= room &&
           (!tma || (two_d(n, c0_in, CLO ? c1_in : c0_in) &&
                     plane_map(&maps.c0, c0_in, m, n, 32 * cpt,
                               geo.mbox_rows) &&
                     (!CLO || plane_map(&maps.c1, c1_in, m, n, 32 * cpt,
                                        geo.mbox_rows))));
    if (cstg) {
      geo.stages = room / cstage > MAX_STAGES ? MAX_STAGES
                                               : (int)(room / cstage);
      smem = geo.stages * cstage + sbytes + BAR_BYTES;
    }
  }
  // 16- or 8-byte C access where N and every C plane allow it
  const uintptr_t cptr = (uintptr_t)c0 | (uintptr_t)c1 | (uintptr_t)c0_in |
                         (uintptr_t)c1_in;
  const bool vec_c = n % cpt == 0 && !(cptr & (cpt * 4 - 1));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPGEMM_LAUNCH(STAGED, SHS, CPT, CSTG)                                 \
  launch_kernel<F64, BLO, CLO, ACC, STAGED, SHS, CPT, CSTG>(                  \
      maps, row_ptr, cols, vh, vl, bh, bl, c0_in, c1_in, c0, c1, m, k, n, nnz, \
      geo, tma, vec_c, (int)smem, device, st)
  if (staging == ST_UNSTAGED)
    return shs ? SPGEMM_LAUNCH(false, true, WIDE, false)
               : SPGEMM_LAUNCH(false, false, WIDE, false);
  if constexpr (ACC) {
    if (cstg)
      return shs ? SPGEMM_LAUNCH(true, true, WIDE, true)
                 : SPGEMM_LAUNCH(true, false, WIDE, true);
  }
  if (cpt == WIDE)
    return shs ? SPGEMM_LAUNCH(true, true, WIDE, false)
               : SPGEMM_LAUNCH(true, false, WIDE, false);
  return shs ? SPGEMM_LAUNCH(true, true, 1, false)
             : SPGEMM_LAUNCH(true, false, 1, false);
#undef SPGEMM_LAUNCH
}

// f64: the schedule from which planes are given (bl: B-lo read; cl: C-lo
// written)
template <bool ACC>
int launch_f64(const int* row_ptr, const int* cols, const float* vh,
               const float* vl, const float* bh, const float* bl,
               const float* chin, const float* clin, float* ch, float* cl,
               int m, int k, long long n, int nnz, int staging, int structure,
               int device, void* stream) {
  if (bl && cl)
    return launch<true, true, true, ACC>(row_ptr, cols, vh, vl, bh, bl, chin,
                                         clin, ch, cl, m, k, n, nnz, staging,
                                         structure, device, stream);
  if (bl)
    return launch<true, true, false, ACC>(row_ptr, cols, vh, vl, bh, bl, chin,
                                          clin, ch, cl, m, k, n, nnz, staging,
                                          structure, device, stream);
  if (cl)
    return launch<true, false, true, ACC>(row_ptr, cols, vh, vl, bh, bl, chin,
                                          clin, ch, cl, m, k, n, nnz, staging,
                                          structure, device, stream);
  return launch<true, false, false, ACC>(row_ptr, cols, vh, vl, bh, bl, chin,
                                         clin, ch, cl, m, k, n, nnz, staging,
                                         structure, device, stream);
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t) on
// device `device` and returns cudaGetLastError() (0 = launched), or -2 for
// a route (`staging`, `structure`: the codes above) it cannot run.  The
// operator is (row_ptr [m+1], cols [nnz], values): f32 values for the f32
// kernels, the hi/lo split (vh, vl) for the f64 ones.  B is [k, n], C and
// C_in are [m, n], all f32, row-major and contiguous.  For f64, a null `bl`
// means the schedule reads no B-lo plane and a null `cl` that it folds the
// lo sum into `ch`.  Nothing is allocated and nothing synchronises.
extern "C" int xsmm_spgemm_unroll_f32(const int* row_ptr, const int* cols,
                                      const float* vals, const float* b,
                                      float* c, int m, int k, long long n,
                                      int nnz, int staging, int structure,
                                      int device, void* stream) {
  return launch<false, false, false, false>(
      row_ptr, cols, vals, nullptr, b, nullptr, nullptr, nullptr, c, nullptr,
      m, k, n, nnz, staging, structure, device, stream);
}

extern "C" int xsmm_spgemm_acc_f32(const int* row_ptr, const int* cols,
                                   const float* vals, const float* cin,
                                   const float* b, float* c, int m, int k,
                                   long long n, int nnz, int staging,
                                   int structure, int device, void* stream) {
  return launch<false, false, false, true>(
      row_ptr, cols, vals, nullptr, b, nullptr, cin, nullptr, c, nullptr, m,
      k, n, nnz, staging, structure, device, stream);
}

extern "C" int xsmm_spgemm_unroll_f64(const int* row_ptr, const int* cols,
                                      const float* vh, const float* vl,
                                      const float* bh, const float* bl,
                                      float* ch, float* cl, int m, int k,
                                      long long n, int nnz, int staging,
                                      int structure, int device,
                                      void* stream) {
  return launch_f64<false>(row_ptr, cols, vh, vl, bh, bl, nullptr, nullptr,
                           ch, cl, m, k, n, nnz, staging, structure, device,
                           stream);
}

extern "C" int xsmm_spgemm_acc_f64(const int* row_ptr, const int* cols,
                                   const float* vh, const float* vl,
                                   const float* chin, const float* clin,
                                   const float* bh, const float* bl, float* ch,
                                   float* cl, int m, int k, long long n,
                                   int nnz, int staging, int structure,
                                   int device, void* stream) {
  return launch_f64<true>(row_ptr, cols, vh, vl, bh, bl, chin, clin, ch, cl,
                          m, k, n, nnz, staging, structure, device, stream);
}

// Whether a launch of the kernel with `b_planes` B planes (2: the f64
// kernels' B-lo read), `c_planes` C_in planes (0: unroll; 2: C-lo) and f64
// values (`f64`) on an m x k operator of nnz terms fits route (staging,
// structure) on device `device`: 1 or 0 (the fit the launch itself checks;
// TMA's alignment is the planes' and is not asked), -2 for codes it does
// not know.
extern "C" int xsmm_spgemm_fits(int f64, int b_planes, int c_planes, int m,
                                int k, int nnz, int staging, int structure,
                                int device) {
  if (device < 0 || device >= MAX_DEVICES || b_planes < 1 || b_planes > 2 ||
      c_planes < 0 || c_planes > 2 || staging < ST_TMA ||
      staging > ST_UNSTAGED || structure < SR_SHARED ||
      structure > SR_GLOBAL)
    return -2;
  Geom geo;
  int cpt;
  long long smem;
  return plan(f64 != 0, b_planes, b_planes == 2 ? CPT_TWO : CPT_ONE,
              c_planes > 0, c_planes == 2, m, k, nnz, staging, structure,
              dev_info(device), geo, cpt, smem) == 0;
}
