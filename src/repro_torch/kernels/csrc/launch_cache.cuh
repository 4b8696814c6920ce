// Per-device launch facts, queried once and kept: the SM count, the
// largest dynamic shared memory a block may opt into, and each kernel's
// resident blocks per SM at a given block size and dynamic shared memory.
// A wrapper's launch then costs one cudaGetDevice and a table lookup
// instead of an attribute query, an occupancy query and, above 48 KB, a
// cudaFuncSetAttribute on every call. The tables are guarded by a mutex:
// ctypes releases Python's lock around the call.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace launch_cache {

constexpr int kMaxDevices = 64;
constexpr int kEntries = 256;

struct Device {
  int sms;
  int smem_optin;
};

struct Entry {
  const void* fn;
  int dev, threads, smem, per_sm;
};

inline std::mutex& lock() {
  static std::mutex mu;
  return mu;
}

// The current device, its SM count and its opt-in shared memory per block.
inline cudaError_t device(int* dev, Device* out) {
  static Device table[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock());
  Device& d = table[*dev];
  if (d.sms == 0) {
    Device q{0, 0};
    err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount,
                                 *dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&q.smem_optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   *dev);
    if (err != cudaSuccess) return err;
    d = q;
  }
  *out = d;
  return cudaSuccess;
}

// Resident blocks of `fn` per SM on `dev` at `threads` threads and `smem`
// bytes of dynamic shared memory. The first time a kernel asks for more
// than 48 KB on a device, its limit is raised to the device's opt-in
// maximum (so one setting serves every later size).
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel fn, int dev, const Device& d, int threads,
                          int smem, int* out) {
  static Entry table[kEntries];
  static int next = 0;
  const void* key = reinterpret_cast<const void*>(fn);
  std::lock_guard<std::mutex> guard(lock());
  for (int i = 0; i < kEntries; ++i) {
    const Entry& e = table[i];
    if (e.fn == key && e.dev == dev && e.threads == threads &&
        e.smem == smem) {
      *out = e.per_sm;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem_optin);
  int n = 1;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  table[next] = Entry{key, dev, threads, smem, n};
  next = (next + 1) % kEntries;
  *out = n;
  return cudaSuccess;
}

// Raise `fn`'s dynamic shared memory limit to `smem` bytes on the current
// device, the first time a launch there asks for it. The attribute is per
// device: a flag kept once per process would leave every other card at its
// 48 KB default, and a launch there would fail with an invalid value.
template <typename Kernel>
cudaError_t allow_smem(Kernel fn, int smem) {
  static Entry table[kEntries];
  static int next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(fn);
  std::lock_guard<std::mutex> guard(lock());
  for (int i = 0; i < kEntries; ++i) {
    const Entry& e = table[i];
    if (e.fn == key && e.dev == dev && e.smem >= smem) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  table[next] = Entry{key, dev, 0, smem, 0};
  next = (next + 1) % kEntries;
  return cudaSuccess;
}

}  // namespace launch_cache
