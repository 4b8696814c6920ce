// Diagonal linear recurrence for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linear_scan.py::
// linear_scan (body _scan_kernel), the RG-LRU state update. For a, b
// (B, S, D) float32 or bfloat16, contiguous, and an optional float32 h0
// (B, D):
//
//   h_t = a_t * h_{t-1} + b_t,  h_{-1} = h0 (or 0)
//
// with the state in float32 and h written in a's dtype. Each step is a
// multiply and an add, each rounded (__fmul_rn / __fadd_rn, never fused),
// in order over t, so the kernel and the plain version (kernels/ref.py::
// linear_scan_ref, the same loop in PyTorch) agree bit for bit.
//
// Design: one thread per (b, d) channel, neighbouring threads on
// neighbouring d (coalesced loads and stores), blocks of 64 threads along d
// and one grid row per b; each thread walks S in chunks of 8 steps, loading
// the chunk's a and b before it computes, so 16 loads are in flight per
// thread instead of one.
//
// What bounds it on an H100 SXM: it reads a and b once and writes h once,
// 3 * B * S * D * elt bytes, against 2 flops per element, so it is bound
// by memory: (64, 48, 2560) float32 moves ~94 MB, ~28 us at 3.35 TB/s. With
// few channels (B * D of a few thousand) the card is not filled and the
// serial walk over S dominates; a chunked two-pass scan (per-chunk
// products, then a scan of the chunk carries) is the later fix for that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kChunk = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_scan_fwd(const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ h0, T* __restrict__ out, int S,
                int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long row = blockIdx.y;
  const long long base = row * S * D + d;
  float h = h0 ? h0[row * D + d] : 0.f;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    float av[kChunk], bv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (t0 + u < S) {
        const long long off = base + (long long)(t0 + u) * D;
        av[u] = to_f(a[off]);
        bv[u] = to_f(b[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (t0 + u < S) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        from_f(h, out + base + (long long)(t0 + u) * D);
      }
    }
  }
}

}  // namespace

extern "C" {

// a, b, out (B, S, D) contiguous, all of one dtype (0 = float32,
// 1 = bfloat16), h0 (B, D) contiguous float32 or null, all on the current
// device; B < 65536. Launches on `stream` and returns cudaGetLastError()
// (0 on success); it never synchronises.
int linear_scan_fwd_c(const void* a, const void* b, const float* h0,
                      void* out, int B, int S, int D, int dtype,
                      void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  if (dtype == 0)
    linear_scan_fwd<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), h0,
        static_cast<float*>(out), S, D);
  else if (dtype == 1)
    linear_scan_fwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), h0,
        static_cast<__nv_bfloat16*>(out), S, D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
