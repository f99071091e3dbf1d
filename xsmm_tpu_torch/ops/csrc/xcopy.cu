// Matrix copy and out-of-place transpose: the two Hopper kernels behind
// xsmm_tpu_torch/ops/xcopy_kernels.py, built for sm_90a with a plain C
// interface (loaded through ctypes by ops/cuda_build.py).
//
// Kernels and the TPU kernels they replace:
//   copy   <- xsmm_tpu/ops/xcopy.py:35  _copy_kernel  (MatcopyKernel)
//   trans  <- xsmm_tpu/ops/xcopy.py:105 _trans_kernel (TransKernel)
//
// Bound on an H100 SXM (3.35 TB/s): both move each byte in once and out
// once and compute nothing, so both are bound by device memory.  An 8192^2
// f32 matrix is 268 MB each way: 0.160 ms.
//
// The TPU kernels are DMA pipelines over 512-row (copy) or 512 x 512
// (transpose) VMEM blocks; those sizes are VMEM artifacts and are not kept.
//
// copy.  A byte mover: one kernel serves every dtype.  What it does about
// the bound is to have the whole grid sweep the data in order, as many
// short blocks, each with its loads in flight before its stores:
//   * 16-byte vector loads and stores where source and destination share
//     their offset mod 16 (else the widest of 8, 4, 2, 1 bytes that they
//     share);
//   * block b copies tile b, COPY_THREADS x VPT vectors (8 KB of 16-byte
//     vectors), neighbouring threads on neighbouring vectors; the blocks
//     are dispatched in index order, so the SMs stream through memory
//     together (measured on the H100: a span per persistent block, with or
//     without streaming cache hints, and a cp.async.bulk ring through
//     shared memory all ran 3-7 % slower; PERF.md);
//   * a misaligned head (until the source is aligned to the vector) and a
//     tail shorter than one vector are copied byte by byte by block 0;
//   * byte offsets are 64-bit.
//
// trans.  out[N, M] = in[M, N]^T through a TILE x TILE tile in shared
// memory, one row padded by one element so that reading a column of the
// tile hits TILE different banks.  Each block reads TILE rows of the
// input and writes TILE rows of the output, each row a run of contiguous
// elements across a warp, so both sides are coalesced.  Ragged edges are
// masked, not padded.  One template on the element size (1, 2, 4, 8
// bytes) serves every dtype: the values are moved as bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int VPT = 2;              // vectors a thread has in flight

constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;        // threadIdx.y extent: 4 elements a thread

// Block b copies the tile of vectors [b * TV, (b + 1) * TV), TV =
// COPY_THREADS x VPT: each thread issues its VPT loads (neighbouring threads
// on neighbouring vectors) before its first store.  Block 0 also copies the
// head and the tail, fewer than sizeof(V) bytes each, byte by byte.
template <typename V>
__global__ void __launch_bounds__(COPY_THREADS)
copy_kernel(const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
            long long head, long long nvec, long long nbytes) {
  const V* s = reinterpret_cast<const V*>(src + head);
  V* d = reinterpret_cast<V*>(dst + head);
  constexpr long long TV = (long long)COPY_THREADS * VPT;
  const long long i = (long long)blockIdx.x * TV + threadIdx.x;
  V r[VPT];
#pragma unroll
  for (int u = 0; u < VPT; ++u)
    if (i + u * COPY_THREADS < nvec) r[u] = s[i + u * COPY_THREADS];
#pragma unroll
  for (int u = 0; u < VPT; ++u)
    if (i + u * COPY_THREADS < nvec) d[i + u * COPY_THREADS] = r[u];
  if (blockIdx.x == 0) {
    const long long tid = threadIdx.x;
    const long long tail = head + nvec * (long long)sizeof(V);
    if (tid < head) dst[tid] = src[tid];
    if (tid < nbytes - tail) dst[tail + tid] = src[tail + tid];
  }
}

template <typename V>
int launch_copy(const void* src, void* dst, long long nbytes, void* stream) {
  const long long w = sizeof(V);
  long long head = (long long)((w - ((uintptr_t)src & (w - 1))) & (w - 1));
  if (head > nbytes) head = nbytes;
  const long long nvec = (nbytes - head) / w;
  constexpr long long TV = (long long)COPY_THREADS * VPT;
  long long blocks = (nvec + TV - 1) / TV;
  if (blocks < 1) blocks = 1;  // the head and tail need one block
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  copy_kernel<V><<<(unsigned)blocks, COPY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), head, nvec,
      nbytes);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(TILE * TILE_ROWS)
trans_kernel(const T* __restrict__ in, T* __restrict__ out, long long M,
             long long N) {
  __shared__ T tile[TILE][TILE + 1];
  const long long x0 = (long long)blockIdx.x * TILE;  // input column tile
  const long long tiles_m = (M + TILE - 1) / TILE;
  for (long long by = blockIdx.y; by < tiles_m; by += gridDim.y) {
    const long long y0 = by * TILE;                     // input row tile
    const long long x = x0 + threadIdx.x;
#pragma unroll
    for (int j = threadIdx.y; j < TILE; j += TILE_ROWS) {
      const long long y = y0 + j;
      if (y < M && x < N) tile[j][threadIdx.x] = in[y * N + x];
    }
    __syncthreads();
    const long long yo = y0 + threadIdx.x;              // output column
#pragma unroll
    for (int j = threadIdx.y; j < TILE; j += TILE_ROWS) {
      const long long xo = x0 + j;                      // output row
      if (xo < N && yo < M) out[xo * M + yo] = tile[threadIdx.x][j];
    }
    __syncthreads();
  }
}

template <typename T>
int launch_trans(const void* in, void* out, long long m, long long n,
                 void* stream) {
  const long long tiles_n = (n + TILE - 1) / TILE;
  const long long tiles_m = (m + TILE - 1) / TILE;
  if (tiles_n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned gy = (unsigned)(tiles_m < 65535 ? tiles_m : 65535);
  trans_kernel<T><<<dim3((unsigned)tiles_n, gy), dim3(TILE, TILE_ROWS), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches one kernel on `stream` (a cudaStream_t) on
// device `device` and returns cudaGetLastError() (0 = launched); -1 means
// an element size the kernel does not take.  Nothing is allocated and
// nothing synchronises.

// dst[0:nbytes] = src[0:nbytes]; any alignment, any byte count >= 1.
extern "C" int xsmm_copy(const void* src, void* dst, long long nbytes,
                         int device, void* stream) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  // the widest vector whose alignment source and destination share
  const uintptr_t diff = (uintptr_t)src - (uintptr_t)dst;
  if (!(diff & 15)) return launch_copy<uint4>(src, dst, nbytes, stream);
  if (!(diff & 7)) return launch_copy<uint2>(src, dst, nbytes, stream);
  if (!(diff & 3)) return launch_copy<uint32_t>(src, dst, nbytes, stream);
  if (!(diff & 1)) return launch_copy<uint16_t>(src, dst, nbytes, stream);
  return launch_copy<uint8_t>(src, dst, nbytes, stream);
}

// out[n, m] = in[m, n]^T, both row-major; elements of `elem_size` bytes.
extern "C" int xsmm_trans(const void* in, void* out, long long m, long long n,
                          int elem_size, int device, void* stream) {
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  switch (elem_size) {
    case 1:
      return launch_trans<uint8_t>(in, out, m, n, stream);
    case 2:
      return launch_trans<uint16_t>(in, out, m, n, stream);
    case 4:
      return launch_trans<uint32_t>(in, out, m, n, stream);
    case 8:
      return launch_trans<uint64_t>(in, out, m, n, stream);
    default:
      return -1;
  }
}
