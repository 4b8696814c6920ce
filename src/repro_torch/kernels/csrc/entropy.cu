// Predictive entropy per row for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/uncertainty.py::
// entropy_scores (body _entropy_kernel). For each row x of an (N, V) float32
// or bfloat16 matrix of logits:
//
//   H = -sum_i p_i log p_i,   p = softmax(x)
//
// computed in one read of the row from three running statistics: the max m,
// Z = sum_i e^(x_i - m) and S = sum_i e^(x_i - m) (x_i - m). Then
//
//   H = log max(Z, 1e-30) - S / Z
//
// which is the TPU kernel's m + log Z - S1/Z with S1 = S + m Z: the same
// function, but accumulated relative to m, so large logits do not cancel m
// against S1/Z (S <= 0 and Z >= 1, so both terms are non-negative). Logits
// must be finite: a -inf entry gives NaN, as in the plain version.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel reads N*V*elt bytes and
// writes 4*N; its ~5 float operations and one exp per element stay below the
// SFU and FP32 rates even for bfloat16, so it is bound by memory:
//   learner, (64*3000, 10) f32: 8.4 MB -> 2.5 us;
//   LM vocab, (512, 50304) f32: 103 MB -> 30.8 us.
//
// Design for this card rather than the TPU block (the TPU kernel pads both
// axes to 256 x 512 tiles; nothing here is padded, tails are masked):
//  * narrow rows (V <= 64, the learner's 2..64 classes), each lane or
//    thread reducing one row in two passes, its max, then Z and S:
//      - up to 16 wide (the learning loop's 2 and 10 classes): a thread per
//        row reads it twice through L1, with no staging; at the learning
//        shapes every row is in flight in one wave, so a pipeline across
//        tiles has nothing to overlap;
//      - 17..64 wide: entropy_narrow, where each warp copies the 32*V
//        contiguous values of 32 rows into shared memory with coalesced
//        loads (row stride V|1, odd, so the lanes hit distinct banks) and
//        each lane then reduces one row from there;
//    route narrow_v1 forces entropy_narrow at any V <= 64, for comparison;
//    both kernels give the same bits;
//  * wide rows (V > 64, up to the LM vocab 50304): a group of G warps per row
//    (G = 1, 2, 4 or 8, the least that puts enough warps in flight for N
//    rows), 16-byte vector loads from the first 16-byte boundary of the row
//    (a scalar head and tail around it), four loads in flight per thread;
//    each thread keeps (m, Z, S), rescaling by e^(m_old - m_new) once per
//    vector, and the threads merge by warp shuffles, then across the group's
//    warps through shared memory:
//      m = max(m1, m2),  Z = sum_k e^(mk - m) Zk,
//      S = sum_k e^(mk - m) (Sk + (mk - m) Zk).
// The reduction order is fixed, so results repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr int kThreads = 256;              // wide kernel: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNarrowWarps = 4;            // narrow_v1 kernel: 4 warps
constexpr int kNarrowMax = 64;             // widest row of the narrow path
constexpr int kRowsMax = 16;               // widest row of the rows kernel
constexpr unsigned kFull = 0xffffffffu;

struct Stat {
  float m;   // running max
  float z;   // sum e^(x - m)
  float s;   // sum e^(x - m) (x - m)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16-byte vector -> K floats (K = 4 for float32, 8 for bfloat16; bfloat16 is
// the upper half of a float32, element 0 in the low half of each word)
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

// Fold K values into the running statistics: one rescale at most, then one
// exp per value.
template <int K>
__device__ __forceinline__ void push(Stat& st, const float (&x)[K]) {
  float cm = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) cm = fmaxf(cm, x[k]);
  if (cm > st.m) {
    if (st.z > 0.f) {
      const float d = st.m - cm;
      const float a = __expf(d);
      st.s = a * fmaf(d, st.z, st.s);
      st.z = a * st.z;
    }
    st.m = cm;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d = x[k] - st.m;
    const float e = __expf(d);
    st.z += e;
    st.s = fmaf(e, d, st.s);
  }
}

__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  Stat r{fmaxf(a.m, b.m), 0.f, 0.f};
  if (a.z > 0.f) {
    const float d = a.m - r.m, e = __expf(d);
    r.z += e * a.z;
    r.s += e * fmaf(d, a.z, a.s);
  }
  if (b.z > 0.f) {
    const float d = b.m - r.m, e = __expf(d);
    r.z += e * b.z;
    r.s += e * fmaf(d, b.z, b.s);
  }
  return r;
}

__device__ __forceinline__ float finish(const Stat& st) {
  return logf(fmaxf(st.z, 1e-30f)) - st.s / st.z;
}

// Narrow rows: a warp stages 32 rows in shared memory, a lane reduces one.
template <typename T>
__global__ void __launch_bounds__(kNarrowWarps * 32)
entropy_narrow(const T* __restrict__ x, float* __restrict__ out, long long N,
               int V) {
  extern __shared__ float tile[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vs = V | 1;
  float* t = tile + warp * 32 * vs;
  const long long row0 = ((long long)blockIdx.x * kNarrowWarps + warp) * 32;
  if (row0 >= N) return;                  // the whole warp: no block sync
  const int rows = N - row0 < 32 ? (int)(N - row0) : 32;
  const int n = rows * V;
  const T* src = x + row0 * V;
  for (int i = lane; i < n; i += 32) {
    const int r = i / V;
    t[r * vs + (i - r * V)] = to_f(__ldg(src + i));
  }
  __syncwarp();
  if (lane < rows) {
    const float* rp = t + lane * vs;
    float m = rp[0];
    for (int c = 1; c < V; ++c) m = fmaxf(m, rp[c]);
    Stat st{m, 0.f, 0.f};
    for (int c = 0; c < V; ++c) {
      const float d = rp[c] - m;
      const float e = __expf(d);
      st.z += e;
      st.s = fmaf(e, d, st.s);
    }
    out[row0 + lane] = finish(st);
  }
}

// Narrow rows up to kRowsMax wide: a thread per row, read twice through L1,
// with the arithmetic of entropy_narrow.
template <typename T>
__global__ void __launch_bounds__(kThreads)
entropy_narrow_rows(const T* __restrict__ x, float* __restrict__ out,
                    long long N, int V) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= N) return;
  const T* rp = x + row * V;
  float m = to_f(__ldg(rp));
  for (int c = 1; c < V; ++c) m = fmaxf(m, to_f(__ldg(rp + c)));
  Stat st{m, 0.f, 0.f};
  for (int c = 0; c < V; ++c) {
    const float d = to_f(__ldg(rp + c)) - m;
    const float e = __expf(d);
    st.z += e;
    st.s = fmaf(e, d, st.s);
  }
  out[row] = finish(st);
}

// One thread's share of a row: elements r, r + g, r + 2g, ... of the scalar
// head, of the 16-byte vectors, and of the scalar tail.
template <typename T>
__device__ Stat row_stat(const T* __restrict__ row, int V, int r, int g) {
  constexpr int K = 16 / sizeof(T);
  Stat st{-INFINITY, 0.f, 0.f};
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  int head = (int)(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > V) head = V;
  for (int i = r; i < head; i += g) {
    const float v[1] = {to_f(__ldg(row + i))};
    push<1>(st, v);
  }
  const int nvec = (V - head) / K;
  const uint4* vp = reinterpret_cast<const uint4*>(row + head);
  int i = r;
  for (; i + 3 * g < nvec; i += 4 * g) {
    const uint4 u0 = __ldg(vp + i), u1 = __ldg(vp + i + g);
    const uint4 u2 = __ldg(vp + i + 2 * g), u3 = __ldg(vp + i + 3 * g);
    float f[K];
    unpack(u0, f); push<K>(st, f);
    unpack(u1, f); push<K>(st, f);
    unpack(u2, f); push<K>(st, f);
    unpack(u3, f); push<K>(st, f);
  }
  for (; i < nvec; i += g) {
    float f[K];
    unpack(__ldg(vp + i), f);
    push<K>(st, f);
  }
  for (int j = head + nvec * K + r; j < V; j += g) {
    const float v[1] = {to_f(__ldg(row + j))};
    push<1>(st, v);
  }
  return st;
}

// Wide rows: G warps per row, kWarps / G rows per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
entropy_wide(const T* __restrict__ x, float* __restrict__ out, long long N,
             int V, int G) {
  __shared__ float red[3][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / G, wig = warp % G;
  const long long row = (long long)blockIdx.x * (kWarps / G) + grp;
  Stat st{-INFINITY, 0.f, 0.f};
  if (row < N) st = row_stat(x + row * V, V, wig * 32 + lane, G * 32);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stat o{__shfl_xor_sync(kFull, st.m, off),
                 __shfl_xor_sync(kFull, st.z, off),
                 __shfl_xor_sync(kFull, st.s, off)};
    st = merge(st, o);
  }
  if (G > 1) {                            // G is the same for the block
    if (lane == 0) {
      red[0][warp] = st.m;
      red[1][warp] = st.z;
      red[2][warp] = st.s;
    }
    __syncthreads();
    if (wig == 0 && lane == 0)
      for (int j = 1; j < G; ++j)
        st = merge(st, Stat{red[0][warp + j], red[1][warp + j],
                            red[2][warp + j]});
  }
  if (row < N && wig == 0 && lane == 0) out[row] = finish(st);
}

// route: 0 narrow (V <= 64: the rows kernel up to kRowsMax, else
// entropy_narrow), 1 wide, 2 narrow_v1 (entropy_narrow, V <= 64)
template <typename T>
cudaError_t launch(const void* x, float* out, long long N, int V, int route,
                   cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (route == 0 && V <= kRowsMax) {
    const long long blocks = (N + kThreads - 1) / kThreads;
    entropy_narrow_rows<T><<<(unsigned)blocks, kThreads, 0, st>>>(xt, out,
                                                                  N, V);
    return cudaSuccess;
  }
  if (route == 0 || route == 2) {
    if (V > kNarrowMax) return cudaErrorInvalidValue;
    const int smem = kNarrowWarps * 32 * (V | 1) * (int)sizeof(float);
    const long long blocks = (N + kNarrowWarps * 32 - 1) / (kNarrowWarps * 32);
    entropy_narrow<T><<<(unsigned)blocks, kNarrowWarps * 32, smem, st>>>(
        xt, out, N, V);
    return cudaSuccess;
  }
  if (route != 1) return cudaErrorInvalidValue;
  int dev = 0;
  launch_cache::Device d{};
  const cudaError_t err = launch_cache::device(&dev, &d);
  if (err != cudaSuccess) return err;
  // enough warps in flight to cover the card's memory latency: up to 64
  // resident warps on each SM
  const long long want = 64LL * d.sms;
  constexpr int K = 16 / sizeof(T);
  int G = 1;
  while (G < kWarps && N * G < want && V >= G * 2 * 32 * K * 4) G <<= 1;
  const int rows_per_block = kWarps / G;
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  entropy_wide<T><<<(unsigned)blocks, kThreads, 0, st>>>(xt, out, N, V, G);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x (N, V) contiguous, float32 (dtype 0) or bfloat16 (dtype 1), out (N,)
// float32, both on the current device, N >= 1 and V >= 1; route 0 narrow
// and 2 narrow_v1 take V <= 64, route 1 (wide) any V
// (kernels/uncertainty.py::entropy_route). Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue where the
// route cannot take the shape; it never synchronises.
int entropy_rows(const void* x, float* out, long long N, int V, int dtype,
                 int route, void* stream) {
  if (N <= 0 || V <= 0) return 0;
  if (N > 0x7fffffffLL * kNarrowWarps) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, out, N, V, route, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, out, N, V, route, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
