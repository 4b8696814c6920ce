// Streaming-vocab cross entropy for NVIDIA Hopper (sm_90a), plain C
// interface: a forward kernel and its backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/xent.py::streaming_xent
// (body _xent_kernel). For logits x (N, V), float32 or bfloat16, and
// targets t (N,) int32:
//
//   forward:   lse_i  = log sum_j e^(x_ij)          (float32)
//              loss_i = lse_i - x_{i, t_i}          (float32)
//   backward:  dx_ij  = g_i (e^(x_ij - lse_i) - [j = t_i])   (x's dtype)
//
// The forward reads each row once, keeping a running max m and
// Z = sum e^(x - m) (lse = m + log max(Z, 1e-30), as the TPU kernel
// finishes), and reads the target logit by index; it writes loss and lse,
// and lse is what the backward needs: the backward reads x once and writes
// dx once, and never materializes the probabilities. A target outside
// [0, V) gives a NaN loss (the plain version raises).
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): bytes. At
// the training shape, 2048 x 256000 float32, the forward reads 2.1 GB
// (0.63 ms) against one exp and ~4 float operations per logit (~0.13 ms of
// the SFU's exp rate); the backward reads and writes 2.1 GB each (1.25 ms).
//
// Design for this card rather than the TPU block (the TPU kernel pads both
// axes to 256 x 512 tiles and carries (m, Z, x_t) across the sequential
// vocab grid axis in VMEM scratch; blocks here run in no order, so a loop
// inside the block takes the place of that axis):
//  * forward: one block of 256 threads per row; 16-byte vector loads from
//    the row's first 16-byte boundary (a scalar head and tail around them),
//    four loads in flight per thread; each thread keeps (m, Z), rescaling
//    once per vector, and the block merges the threads' pairs by warp
//    shuffles and then across warps through shared memory, in a fixed
//    order, so results repeat bit for bit;
//  * backward: a 2-d grid of (rows, chunks of the row); each thread writes
//    its elements with 16-byte vectors where x and dx share their alignment
//    (a fresh dx always does for a contiguous x), scalar otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBwdVecs = 4;                 // vectors per thread, backward
constexpr unsigned kFull = 0xffffffffu;

struct Stat {
  float m;   // running max
  float z;   // sum e^(x - m)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// 16-byte vector <-> K floats (K = 4 for float32, 8 for bfloat16; bfloat16
// is the upper half of a float32, element 0 in the low half of each word)
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k]));
    const unsigned hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Fold K values into (m, Z): one rescale at most, then one exp per value.
template <int K>
__device__ __forceinline__ void push(Stat& st, const float (&x)[K]) {
  float cm = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) cm = fmaxf(cm, x[k]);
  if (cm > st.m) {
    st.z *= __expf(st.m - cm);              // 0 * e^(-inf) = 0 at the start
    st.m = cm;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) st.z += __expf(x[k] - st.m);
}

__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  const float m = fmaxf(a.m, b.m);
  float z = 0.f;
  if (a.z > 0.f) z += a.z * __expf(a.m - m);
  if (b.z > 0.f) z += b.z * __expf(b.m - m);
  return Stat{m, z};
}

// The first element of a row at a 16-byte boundary (at most V).
template <typename T>
__device__ __forceinline__ int aligned_head(const T* row, int V) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const int head = (int)(((16 - (addr & 15)) & 15) / sizeof(T));
  return head > V ? V : head;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd(const T* __restrict__ x, const int* __restrict__ tgt,
         float* __restrict__ loss, float* __restrict__ lse, int V) {
  constexpr int K = 16 / sizeof(T);
  __shared__ float red[2][kWarps];
  const long long i = blockIdx.x;
  const T* row = x + i * V;
  const int r = threadIdx.x, g = kThreads;
  Stat st{-INFINITY, 0.f};
  const int head = aligned_head(row, V);
  for (int j = r; j < head; j += g) {
    const float v[1] = {to_f(__ldg(row + j))};
    push<1>(st, v);
  }
  const int nvec = (V - head) / K;
  const uint4* vp = reinterpret_cast<const uint4*>(row + head);
  int j = r;
  for (; j + 3 * g < nvec; j += 4 * g) {
    const uint4 u0 = __ldg(vp + j), u1 = __ldg(vp + j + g);
    const uint4 u2 = __ldg(vp + j + 2 * g), u3 = __ldg(vp + j + 3 * g);
    float f[K];
    unpack(u0, f); push<K>(st, f);
    unpack(u1, f); push<K>(st, f);
    unpack(u2, f); push<K>(st, f);
    unpack(u3, f); push<K>(st, f);
  }
  for (; j < nvec; j += g) {
    float f[K];
    unpack(__ldg(vp + j), f);
    push<K>(st, f);
  }
  for (int c = head + nvec * K + r; c < V; c += g) {
    const float v[1] = {to_f(__ldg(row + c))};
    push<1>(st, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stat o{__shfl_xor_sync(kFull, st.m, off),
                 __shfl_xor_sync(kFull, st.z, off)};
    st = merge(st, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = st.m;
    red[1][warp] = st.z;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      st = merge(st, Stat{red[0][w], red[1][w]});
    const float l = st.m + logf(fmaxf(st.z, 1e-30f));
    const int t = tgt[i];
    const float xt = (t >= 0 && t < V) ? to_f(row[t]) : NAN;
    lse[i] = l;
    loss[i] = l - xt;
  }
}

// dx = g (e^(x - lse) - [j = t]) for K consecutive elements starting at
// column c
template <int K>
__device__ __forceinline__ void grad_vals(float (&f)[K], int c, float gi,
                                          float li, int t) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    f[k] = gi * (__expf(f[k] - li) - (c + k == t ? 1.f : 0.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd(const T* __restrict__ x, const int* __restrict__ tgt,
         const float* __restrict__ lse, const float* __restrict__ gout,
         T* __restrict__ dx, int V, int vec) {
  constexpr int K = 16 / sizeof(T);
  const long long i = blockIdx.x;
  const T* row = x + i * V;
  T* drow = dx + i * V;
  const float gi = gout[i], li = lse[i];
  const int t = tgt[i];
  if (vec) {
    const int head = aligned_head(row, V);
    const int nvec = (V - head) / K;
    if (blockIdx.y == 0) {                  // the scalar head and tail
      for (int c = threadIdx.x; c < head; c += kThreads) {
        float f[1] = {to_f(row[c])};
        grad_vals<1>(f, c, gi, li, t);
        from_f(f[0], drow + c);
      }
      for (int c = head + nvec * K + threadIdx.x; c < V; c += kThreads) {
        float f[1] = {to_f(row[c])};
        grad_vals<1>(f, c, gi, li, t);
        from_f(f[0], drow + c);
      }
    }
    const uint4* vp = reinterpret_cast<const uint4*>(row + head);
    uint4* dp = reinterpret_cast<uint4*>(drow + head);
    const int v0 = blockIdx.y * kThreads * kBwdVecs + threadIdx.x;
    uint4 u[kBwdVecs];
#pragma unroll
    for (int q = 0; q < kBwdVecs; ++q) {
      const int v = v0 + q * kThreads;
      if (v < nvec) u[q] = __ldg(vp + v);
    }
#pragma unroll
    for (int q = 0; q < kBwdVecs; ++q) {
      const int v = v0 + q * kThreads;
      if (v < nvec) {
        float f[K];
        unpack(u[q], f);
        grad_vals<K>(f, head + v * K, gi, li, t);
        dp[v] = pack(f);
      }
    }
  } else {
    const int c0 = blockIdx.y * kThreads * kBwdVecs * K;
    const int c1 = min(V, c0 + kThreads * kBwdVecs * K);
    for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
      float f[1] = {to_f(row[c])};
      grad_vals<1>(f, c, gi, li, t);
      from_f(f[0], drow + c);
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const int* tgt, const float* lse,
                       const float* gout, void* dx, long long N, int V,
                       cudaStream_t st) {
  constexpr int K = 16 / sizeof(T);
  const int vec = ((reinterpret_cast<uintptr_t>(x) -
                    reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  const long long per_block = (long long)kThreads * kBwdVecs * K;
  const dim3 grid((unsigned)N, (unsigned)((V + per_block - 1) / per_block));
  xent_bwd<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), tgt, lse,
                                          gout, static_cast<T*>(dx), V, vec);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x (N, V) contiguous, float32 (dtype 0) or bfloat16 (dtype 1); tgt (N,)
// int32; loss and lse (N,) float32; all on the current device; 1 <= N <
// 2^31, 1 <= V < 2^31. Launches on `stream` and returns cudaGetLastError()
// (0 on success); it never synchronises.
int xent_fwd_c(const void* x, const int* tgt, float* loss, float* lse,
               long long N, int V, int dtype, void* stream) {
  if (N <= 0 || V <= 0) return 0;
  if (N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    xent_fwd<float><<<(unsigned)N, kThreads, 0, st>>>(
        static_cast<const float*>(x), tgt, loss, lse, V);
  else if (dtype == 1)
    xent_fwd<__nv_bfloat16><<<(unsigned)N, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), tgt, loss, lse, V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x and dx (N, V) contiguous, of one dtype (0 = float32, 1 = bfloat16);
// tgt (N,) int32; lse and gout (N,) float32; all on the current device;
// 1 <= N < 2^31, 1 <= V < 2^27. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
int xent_bwd_c(const void* x, const int* tgt, const float* lse,
               const float* gout, void* dx, long long N, int V, int dtype,
               void* stream) {
  if (N <= 0 || V <= 0) return 0;
  if (N > 0x7fffffffLL || V >= (1 << 27)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_bwd<float>(x, tgt, lse, gout, dx, N, V, st);
  else if (dtype == 1)
    err = launch_bwd<__nv_bfloat16>(x, tgt, lse, gout, dx, N, V, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
