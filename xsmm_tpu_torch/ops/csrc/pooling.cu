// The backward of 2x2, stride-2, unpadded max pooling over NHWC: the Hopper
// kernel behind xsmm_tpu_torch/dnn/pooling.py, built for sm_90a with a
// plain C interface (loaded through ctypes by ops/cuda_build.py).
//
// Replaces: xsmm_tpu/dnn/pooling.py:33 _maxpool2x2_bwd_pallas.
//
// What it computes (pooling.py:48-67): for every output pixel (n, oh, ow)
// and channel, the window's four elements in row-major order
//   ea = x[n, 2oh, 2ow], eb = x[n, 2oh, 2ow+1],
//   oa = x[n, 2oh+1, 2ow], ob = x[n, 2oh+1, 2ow+1],
// m = max(max(ea, eb), max(oa, ob)) with NaN propagating as jnp.maximum
// does, and dy[n, oh, ow] goes to the first element >= m; the other three
// get 0.  A window holding a NaN has m = NaN, no element is >= m, and the
// whole window gets 0, as in the Pallas kernel.  f32 in and out.
//
// Bound on an H100 SXM (3.35 TB/s): 14 comparisons and selects an element
// against 4 + 1 + 4 floats moved, so it is bound by device memory: read x,
// read dy, write dx once each.  At N64 C256 H56 W56 that is 205.5 + 51.4 +
// 205.5 MB = 462 MB, 0.138 ms.
//
// The TPU kernel views x as [N*H/2, 2*W*C] so that each window element is
// a static, contiguous C-wide lane slice of a VMEM block; that layout is a
// VMEM artifact and is not kept.  Here a thread owns (n, oh, ow) and four
// channels: one 16-byte load of each of the four x quads and of dy, four
// 16-byte stores, neighbouring threads on neighbouring channel quads, so a
// warp reads and writes 512 contiguous bytes a row (C % 4 == 0).  The grid
// strides over the (n, oh, ow, quad) space with a few blocks an SM and the
// loads of one item issued before its stores, to keep enough bytes in
// flight; x and dy are read once (non-coherent, streaming) and dx is
// written with streaming stores, since nothing here reads them again.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ float max_nan(float a, float b) {
  // jnp.maximum: NaN if either is NaN
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ void route(float ea, float eb, float oa, float ob,
                                      float g, float& da, float& db,
                                      float& dc, float& dd) {
  const float m = max_nan(max_nan(ea, eb), max_nan(oa, ob));
  const bool m1 = ea >= m;
  const bool m2 = (eb >= m) && !m1;
  const bool m12 = m1 || m2;
  const bool m3 = (oa >= m) && !m12;
  const bool m4 = (ob >= m) && !(m12 || m3);
  da = m1 ? g : 0.f;
  db = m2 ? g : 0.f;
  dc = m3 ? g : 0.f;
  dd = m4 ? g : 0.f;
}

__global__ void __launch_bounds__(THREADS)
maxpool2x2_bwd_kernel(const float4* __restrict__ x,
                      const float4* __restrict__ dy, float4* __restrict__ dx,
                      long long items, int ow_n, int oh_n, int w, int c4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long row = (long long)w * c4;   // quads in one input row
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    const int q = (int)(i % c4);
    long long t = i / c4;
    const int ow = (int)(t % ow_n);
    t /= ow_n;
    const int oh = (int)(t % oh_n);
    const long long n = t / oh_n;
    const long long a = ((n * (2LL * oh_n) + 2 * oh) * w + 2 * ow) * c4 + q;
    const float4 ea = __ldcs(x + a);
    const float4 eb = __ldcs(x + a + c4);
    const float4 oa = __ldcs(x + a + row);
    const float4 ob = __ldcs(x + a + row + c4);
    const float4 g = __ldcs(dy + i);
    float4 r1, r2, r3, r4;
    route(ea.x, eb.x, oa.x, ob.x, g.x, r1.x, r2.x, r3.x, r4.x);
    route(ea.y, eb.y, oa.y, ob.y, g.y, r1.y, r2.y, r3.y, r4.y);
    route(ea.z, eb.z, oa.z, ob.z, g.z, r1.z, r2.z, r3.z, r4.z);
    route(ea.w, eb.w, oa.w, ob.w, g.w, r1.w, r2.w, r3.w, r4.w);
    __stcs(dx + a, r1);
    __stcs(dx + a + c4, r2);
    __stcs(dx + a + row, r3);
    __stcs(dx + a + row + c4, r4);
  }
}

}  // namespace

// dx[N, H, W, C] from x[N, H, W, C] and dy[N, H/2, W/2, C], all f32,
// contiguous and 16-byte aligned; H and W even, C % 4 == 0.  Launches one
// kernel on `stream` (a cudaStream_t) on device `device` and returns
// cudaGetLastError() (0 = launched); -2 for sizes the kernel does not take
// (nothing launched).  Nothing is allocated and nothing synchronises.
extern "C" int xsmm_maxpool2x2_bwd(const void* x, const void* dy, void* dx,
                                   int n, int h, int w, int c, int device,
                                   void* stream) {
  if (n < 0 || h < 0 || w < 0 || c < 0 || (h | w) & 1 || c & 3) return -2;
  cudaError_t rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  const long long items = (long long)n * (h / 2) * (w / 2) * (c / 4);
  if (items == 0) return 0;
  int sms = 0;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return (int)rc;
  long long blocks = (items + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  maxpool2x2_bwd_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(dy),
      static_cast<float4*>(dx), items, w / 2, h / 2, w, c / 4);
  return (int)cudaGetLastError();
}
