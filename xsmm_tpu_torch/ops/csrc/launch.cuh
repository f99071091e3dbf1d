// The card's facts and each kernel's launch set-up, asked of the runtime
// once and kept, for every library of csrc/.  ctypes calls run without the
// GIL: one lock guards the caches; a kept answer makes no CUDA call.
#pragma once

#include <map>
#include <mutex>
#include <tuple>

// a block's shared memory on every sm_90a card, the only target
// (cuda_build.NVCC_FLAGS); ops/smm_packed.py NATURAL_MAX_SMEM mirrors it
constexpr int BLOCK_SMEM_MAX = 232448;

// a device's SM count and whether it launches cooperative kernels; `err` is
// the query's (then sms is 0 and nothing is kept)
struct DeviceFacts {
  cudaError_t err;
  int sms;
  bool coop;
};

namespace launch_cache {
inline std::mutex mu;
inline std::map<int, DeviceFacts> devices;
inline std::map<std::tuple<const void*, int>, size_t> smem;
inline std::map<std::tuple<const void*, int, size_t, int>, int> per_sm;

// A kernel's dynamic shared-memory limit is raised to a launch's size,
// never lowered: a size once launched stays allowed.  (Not the card's
// maximum: the kernel's static shared memory counts against that.)
inline cudaError_t raise_smem(const void* kern, size_t bytes, int device) {
  size_t& set = smem[std::make_tuple(kern, device)];
  if (bytes <= set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) set = bytes;
  return e;
}
}  // namespace launch_cache

inline DeviceFacts device_facts(int device) {
  const std::lock_guard<std::mutex> hold(launch_cache::mu);
  const auto it = launch_cache::devices.find(device);
  if (it != launch_cache::devices.end()) return it->second;
  int sms = 0, coop = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return DeviceFacts{e, 0, false};
  return launch_cache::devices[device] = DeviceFacts{e, sms, coop != 0};
}

// before a launch of `kern` with `smem` bytes on `device` (the current one)
template <typename Kernel>
cudaError_t prepare(Kernel kern, size_t smem, int device) {
  const std::lock_guard<std::mutex> hold(launch_cache::mu);
  return launch_cache::raise_smem(reinterpret_cast<const void*>(kern), smem,
                                  device);
}

// prepare(), then into *per_sm the blocks of `threads` threads an SM keeps
// resident (0 where none fit, or after the error returned)
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kern, int threads, size_t smem, int device,
                          int* per_sm) {
  const void* k = reinterpret_cast<const void*>(kern);
  const std::lock_guard<std::mutex> hold(launch_cache::mu);
  const auto key = std::make_tuple(k, threads, smem, device);
  const auto it = launch_cache::per_sm.find(key);
  if (it != launch_cache::per_sm.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  cudaError_t e = launch_cache::raise_smem(k, smem, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, threads, smem);
  if (e != cudaSuccess) *per_sm = 0;
  else launch_cache::per_sm[key] = *per_sm;
  return e;
}
