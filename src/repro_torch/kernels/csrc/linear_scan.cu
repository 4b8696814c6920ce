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
// serial walk over S dominates: each thread has only its chunk's loads in
// flight, and waits for them before its 8 dependent steps.
//
// The chunked pair (linear_scan_chunked_fwd / _bwd) is for that case. A
// block owns 32 consecutive channels of one row b and kWarps warps; warp w
// owns a chunk of kL consecutive steps, and the block walks S in segments
// of kWarps * kL steps:
//   1. the segment's a and b (backward: a_{t+1}, g and h_{t-1}) are staged
//      in shared memory by cp.async, kStages segments in flight (16-byte
//      copies where rows are 16-byte aligned, element loads otherwise);
//   2. each warp forms its chunk's pair from (1, 0), step by step in order:
//      A_c = a * A, B_c = a * B + b;
//   3. the carries are composed in chunk order, H_c = A_c * H_{c-1} + B_c,
//      from h0 (or 0), the last one passed on to the next segment;
//   4. each warp walks its chunk again from H_{c-1} with the sequential
//      kernel's step and writes h.
// The backward does the same walked in reverse over dh_t = g_t + a_{t+1}
// dh_{t+1}, and its second walk writes da_t = dh_t h_{t-1} and db_t = dh_t
// (dh_{S-1} = g_{S-1} as in the sequential kernel). Every multiply and add
// is rounded on its own (no contraction, no atomics) in one fixed order, so
// kernels/ref.py::linear_scan_chunked_ref / linear_scan_chunked_bwd_ref,
// which run the same chunks and carries vectorized over chunks, agree with
// them bit for bit; for S <= kL the walk is the sequential one. Traffic is
// the bound's: a and b read once, h written once (backward: a, h, g read
// once, da and db written once).

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
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
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

// ---------------------------------------------------------------------
// The chunked scan.

constexpr int kL = 8;                     // steps per chunk (ref.SCAN_CHUNK)
constexpr int kWarps = 8;                 // chunks per segment
constexpr int kCThreads = 32 * kWarps;
constexpr int kRows = kL * kWarps;        // steps per segment
constexpr int kStages = 3;                // segments staged ahead

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;           // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages rows t0 .. t0 + kRows - 1 of channels d0 .. d0 + 31 of one (S, D)
// array into tile (kRows x 32 elements); rows outside [lo, hi) and channels
// at or past D are zeros. `fast`: rows are 16-byte aligned, so 16-byte
// cp.async copies (D * elt a multiple of 16 puts the edge at a copy's
// boundary); otherwise each thread loads its own elements.
template <typename T>
__device__ __forceinline__ void stage_rows(T* tile, const T* src, int t0,
                                           int lo, int hi, int d0, int D,
                                           bool fast) {
  if (fast) {
    constexpr int kPer = 16 / sizeof(T);  // elements per copy
    constexpr int kCopies = kRows * 32 / kPer;
    for (int i = threadIdx.x; i < kCopies; i += kCThreads) {
      const int r = i / (32 / kPer), c = (i % (32 / kPer)) * kPer;
      const int t = t0 + r;
      const bool ok = t >= lo && t < hi && d0 + c < D;
      const T* g = ok ? src + (long long)t * D + d0 + c : src;
      cp_async16(tile + r * 32 + c, g, ok);
    }
  } else {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int d = d0 + lane;
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const int r = w * kL + u, t = t0 + r;
      tile[r * 32 + lane] =
          (t >= lo && t < hi && d < D) ? src[(long long)t * D + d] : zero<T>();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCThreads)
linear_scan_chunked_fwd(const T* __restrict__ a, const T* __restrict__ b,
                        const float* __restrict__ h0, T* __restrict__ out,
                        int S, int D, int fast) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [kStages][2][kRows][32]
  float* cA = reinterpret_cast<float*>(smem + sizeof(T) * kStages * 2 *
                                                  kRows * 32);
  float* cB = cA + kWarps * 32;           // [kWarps][32] each
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int d0 = blockIdx.x * 32, d = d0 + lane;
  const long long row = blockIdx.y;
  const T* ar = a + row * S * D;
  const T* br = b + row * S * D;
  T* orow = out + row * S * D;
  float carry = (h0 && d < D) ? h0[row * D + d] : 0.f;
  const int nseg = (S + kRows - 1) / kRows;
  auto stage = [&](int k) {
    T* t = tiles + (k % kStages) * 2 * kRows * 32;
    stage_rows(t, ar, k * kRows, 0, S, d0, D, fast);
    stage_rows(t + kRows * 32, br, k * kRows, 0, S, d0, D, fast);
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nseg) stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < nseg; ++k) {
    if (k + kStages - 1 < nseg) stage(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* ta = tiles + (k % kStages) * 2 * kRows * 32 + w * kL * 32;
    const T* tb = ta + kRows * 32;
    float A = 1.f, Bc = 0.f;
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      const float av = to_f(ta[u * 32 + lane]);
      A = __fmul_rn(av, A);
      Bc = __fadd_rn(__fmul_rn(av, Bc), to_f(tb[u * 32 + lane]));
    }
    cA[w * 32 + lane] = A;
    cB[w * 32 + lane] = Bc;
    __syncthreads();
    float h = carry;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j == w) h = carry;
      carry = __fadd_rn(__fmul_rn(cA[j * 32 + lane], carry), cB[j * 32 + lane]);
    }
    const int t0 = k * kRows + w * kL;
#pragma unroll
    for (int u = 0; u < kL; ++u) {
      h = __fadd_rn(__fmul_rn(to_f(ta[u * 32 + lane]), h),
                    to_f(tb[u * 32 + lane]));
      if (d < D && t0 + u < S) from_f(h, orow + (long long)(t0 + u) * D + d);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kCThreads)
linear_scan_chunked_bwd(const T* __restrict__ a, const T* __restrict__ h,
                        const float* __restrict__ h0, const T* __restrict__ g,
                        T* __restrict__ da, T* __restrict__ db,
                        float* __restrict__ dh0, int S, int D, int fast) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [kStages][3][kRows][32]
  float* cA = reinterpret_cast<float*>(smem + sizeof(T) * kStages * 3 *
                                                  kRows * 32);
  float* cB = cA + kWarps * 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int d0 = blockIdx.x * 32, d = d0 + lane;
  const long long row = blockIdx.y;
  const long long base = row * S * D;
  const float hinit = (h0 && d < D) ? h0[row * D + d] : 0.f;
  const int nseg = (S + kRows - 1) / kRows;
  // segments are walked from the last; tile rows are the segment's steps t:
  // a_{t+1} (zero past S - 1), g_t, and h_{t-1} (zero at t = 0 and past
  // S - 1; h0 is used at t = 0)
  auto stage = [&](int i) {
    const int k = nseg - 1 - i;
    T* t = tiles + (i % kStages) * 3 * kRows * 32;
    stage_rows(t, a + base, k * kRows + 1, 0, S, d0, D, fast);
    stage_rows(t + kRows * 32, g + base, k * kRows, 0, S, d0, D, fast);
    stage_rows(t + 2 * kRows * 32, h + base, k * kRows - 1, 0, S - 1, d0, D,
               fast);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nseg) stage(i);
    cp_async_commit();
  }
  float carry = 0.f;                      // dh_{t+1} after the segment
  for (int i = 0; i < nseg; ++i) {
    if (i + kStages - 1 < nseg) stage(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int k = nseg - 1 - i;
    const T* tn = tiles + (i % kStages) * 3 * kRows * 32 + w * kL * 32;
    const T* tg = tn + kRows * 32;
    const T* th = tn + 2 * kRows * 32;
    float A = 1.f, Bc = 0.f;
#pragma unroll
    for (int u = kL - 1; u >= 0; --u) {
      const float an = to_f(tn[u * 32 + lane]);
      A = __fmul_rn(an, A);
      Bc = __fadd_rn(__fmul_rn(an, Bc), to_f(tg[u * 32 + lane]));
    }
    cA[w * 32 + lane] = A;
    cB[w * 32 + lane] = Bc;
    __syncthreads();
    float dh = carry;
#pragma unroll
    for (int j = kWarps - 1; j >= 0; --j) {
      if (j == w) dh = carry;
      carry = __fadd_rn(__fmul_rn(cA[j * 32 + lane], carry), cB[j * 32 + lane]);
    }
    const int t0 = k * kRows + w * kL;
#pragma unroll
    for (int u = kL - 1; u >= 0; --u) {
      const int t = t0 + u;
      if (t < S) {
        const float gv = to_f(tg[u * 32 + lane]);
        dh = t == S - 1 ? gv
                        : __fadd_rn(gv, __fmul_rn(to_f(tn[u * 32 + lane]), dh));
        const float hv = t > 0 ? to_f(th[u * 32 + lane]) : hinit;
        if (d < D) {
          const long long off = base + (long long)t * D + d;
          from_f(__fmul_rn(dh, hv), da + off);
          from_f(dh, db + off);
        }
      }
    }
    if (dh0 && k == 0 && w == 0 && d < D)
      dh0[row * D + d] = __fmul_rn(to_f(a[base + d]), dh);
    __syncthreads();
  }
}

constexpr size_t chunked_smem(size_t elt, int arrays) {
  return elt * kStages * arrays * kRows * 32 + 2 * kWarps * 32 * sizeof(float);
}

// Raises the kernel's dynamic shared memory limit to `bytes`, and asks for
// the largest shared-memory carveout, once per device; returns the CUDA
// error.
template <typename K>
int allow_smem(K kernel, size_t bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) *done |= bit;
  return (int)e;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

// The chunk length kL of the chunked kernels, for the wrapper to check
// against its own constant.
int linear_scan_chunk_c() { return kL; }

// The chunked forward: the arguments of linear_scan_fwd_c. Launches on
// `stream` and returns the CUDA error (0 on success); never synchronises.
int linear_scan_chunked_fwd_c(const void* a, const void* b, const float* h0,
                              void* out, int B, int S, int D, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((D + 31) / 32), (unsigned)B);
  const size_t elt = dtype == 0 ? 4 : 2;
  const int fast = (D * elt) % 16 == 0 && aligned16(a) && aligned16(b);
  const size_t smem = chunked_smem(elt, 2);
  static unsigned long long done[2];
  int err;
  if (dtype == 0) {
    err = allow_smem(linear_scan_chunked_fwd<float>, smem, &done[0]);
    if (err) return err;
    linear_scan_chunked_fwd<float><<<grid, kCThreads, smem, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), h0,
        static_cast<float*>(out), S, D, fast);
  } else {
    err = allow_smem(linear_scan_chunked_fwd<__nv_bfloat16>, smem, &done[1]);
    if (err) return err;
    linear_scan_chunked_fwd<__nv_bfloat16><<<grid, kCThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), h0,
        static_cast<__nv_bfloat16*>(out), S, D, fast);
  }
  return (int)cudaGetLastError();
}

// The chunked backward: the arguments of linear_scan_bwd_c. Launches on
// `stream` and returns the CUDA error (0 on success); never synchronises.
int linear_scan_chunked_bwd_c(const void* a, const void* h, const float* h0,
                              const void* g, void* da, void* db, float* dh0,
                              int B, int S, int D, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((D + 31) / 32), (unsigned)B);
  const size_t elt = dtype == 0 ? 4 : 2;
  const int fast = (D * elt) % 16 == 0 && aligned16(a) && aligned16(h) &&
                   aligned16(g);
  const size_t smem = chunked_smem(elt, 3);
  static unsigned long long done[2];
  int err;
  if (dtype == 0) {
    err = allow_smem(linear_scan_chunked_bwd<float>, smem, &done[0]);
    if (err) return err;
    linear_scan_chunked_bwd<float><<<grid, kCThreads, smem, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(h), h0,
        static_cast<const float*>(g), static_cast<float*>(da),
        static_cast<float*>(db), dh0, S, D, fast);
  } else {
    err = allow_smem(linear_scan_chunked_bwd<__nv_bfloat16>, smem, &done[1]);
    if (err) return err;
    linear_scan_chunked_bwd<__nv_bfloat16><<<grid, kCThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(h), h0,
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(da), static_cast<__nv_bfloat16*>(db),
        dh0, S, D, fast);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
