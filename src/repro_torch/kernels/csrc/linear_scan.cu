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
// The backward (the JAX package differentiates its associative scan; the
// port's forward is this kernel, so its backward is one too) walks t in
// reverse from the output gradient g and the saved output h:
//
//   dh_t = g_t + a_{t+1} * dh_{t+1}   (dh_{S-1} = g_{S-1})
//   da_t = dh_t * h_{t-1}   (h_{-1} = h0 or 0),   db_t = dh_t,
//   dh0 = a_0 * dh_0
//
// each multiply and add rounded separately, as kernels/ref.py::
// linear_scan_bwd_ref does in the same order, so the two agree bit for bit.
// It reads a, h and g once and writes da and db once: bound by memory as
// the forward, 5 * B * S * D * elt bytes.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_scan_bwd(const T* __restrict__ a, const T* __restrict__ h,
                const float* __restrict__ h0, const T* __restrict__ g,
                T* __restrict__ da, T* __restrict__ db,
                float* __restrict__ dh0, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long row = blockIdx.y;
  const long long base = row * S * D + d;
  const float hinit = h0 ? h0[row * D + d] : 0.f;
  float dh = 0.f, a_next = 0.f;
  for (int t1 = S - 1; t1 >= 0; t1 -= kChunk) {
    // steps t1, t1 - 1, ..., t1 - kChunk + 1, loaded ahead
    float gv[kChunk], hv[kChunk], av[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        const long long off = base + (long long)t * D;
        gv[u] = to_f(g[off]);
        av[u] = to_f(a[off]);
        hv[u] = t > 0 ? to_f(h[off - D]) : hinit;
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        dh = t == S - 1 ? gv[u] : __fadd_rn(gv[u], __fmul_rn(a_next, dh));
        const long long off = base + (long long)t * D;
        from_f(__fmul_rn(dh, hv[u]), da + off);
        from_f(dh, db + off);
        a_next = av[u];
      }
    }
  }
  if (dh0) dh0[row * D + d] = __fmul_rn(a_next, dh);
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

// The backward: a, h (the forward's output), g, da, db (B, S, D)
// contiguous, all of one dtype (0 = float32, 1 = bfloat16); h0 (B, D)
// contiguous float32 or null (then h_{-1} = 0); dh0 (B, D) float32 or null
// (not written); all on the current device; B < 65536. Launches on `stream`
// and returns cudaGetLastError() (0 on success); it never synchronises.
int linear_scan_bwd_c(const void* a, const void* h, const float* h0,
                      const void* g, void* da, void* db, float* dh0, int B,
                      int S, int D, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
  if (dtype == 0)
    linear_scan_bwd<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(h), h0,
        static_cast<const float*>(g), static_cast<float*>(da),
        static_cast<float*>(db), dh0, S, D);
  else if (dtype == 1)
    linear_scan_bwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(h), h0,
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(da), static_cast<__nv_bfloat16*>(db),
        dh0, S, D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
