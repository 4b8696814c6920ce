// Flash attention backward for NVIDIA Hopper (sm_90a), plain C interface.
//
// The gradient of csrc/flash_attention.cu's forward, which replaces the
// Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (the JAX package differentiates jnp attention; it has no backward Pallas
// kernel, and the port's forward is a kernel, so its backward is one too).
// For q (B, Hq, Sq, D), k, v (B, Hkv, Sk, D), the forward's output o and
// its row log-sum-exp lse (B, Hq, Sq) float32, and the output gradient do:
//
//   s = scale q k^T (masked: -1e30),  p = e^(s - lse)        (recomputed)
//   delta_i = sum_d do_id o_id
//   dv = p^T do,  dp = do v^T,  ds = p (dp - delta),
//   dq = scale ds k,  dk = scale ds^T q
//
// with q head h reading kv head h / G (G = Hq / Hkv): dk and dv of a kv
// head sum over its G query heads. All arithmetic is float32 (operands
// widened as they are staged); the outputs are rounded once to q's dtype.
//
// Three kernels, launched in order on one stream, none with atomics, so a
// run repeats bit for bit:
//  * flash_bwd_delta: delta = rowsum(do o), one warp per row;
//  * flash_bwd_dq: one block of 256 threads per (batch * q head, 32-row q
//    tile); it keeps q, do, lse and delta of its tile, walks the 32-row k
//    tiles that hold a kept (q, k) pair (causal and window by index, as the
//    forward skips), recomputes p and ds, and accumulates dq in registers;
//  * flash_bwd_dkdv: one block per (batch * kv head, 16-row k tile); it keeps
//    k and v of its tile, walks the G query heads and, for each, the 32-row
//    q tiles with a kept pair, and accumulates dk and dv in registers.
//    16-row k tiles put B * Sk / 16 blocks on the card (128 at the training
//    shape, 4 x 512 tokens with one kv head) instead of 32 for 64-row tiles.
// Tiles sit in dynamic shared memory as float32 rows padded by one word
// (distinct banks for the column reads), (2 * 32 + 2 * 32) * (Dp + 1) * 4
// bytes for dq and (2 * 16 + 2 * 32) * (Dp + 1) * 4 for dk/dv: 135,808 and
// 103,296 bytes at D = 256, set with cudaFuncSetAttribute. Products are FMAs
// out of shared memory, as in the forward.
//
// What bounds it on an H100 SXM: at the training shape, (4, 10 / 1, 512,
// 256) bf16 causal, the function reads q, k, v, o, do and lse once and
// writes dq, dk, dv (46 MB, 13.8 us at 3.35 TB/s) and does 5 products of
// 2 D flops over the 5.25 M kept pairs (13.4 GFLOP, 13.6 us at the bf16
// tensor-core rate), so it is bound by bytes, barely; these kernels, on
// the FMA units out of shared memory, are bound by shared-memory bandwidth
// far above both. Tensor-core tiles are the later step, as for the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;               // q rows per tile
constexpr int kBKq = 32;              // k rows per tile, dq kernel
constexpr int kBKk = 16;              // k rows per block, dk/dv kernel
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int Hq, Hkv, Sq, Sk, D;
  // element strides (batch, head, sequence) of q, k, v, o, do, dq, dk, dv
  long long st[8][3];
  int causal, window;
  float scale;
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + R) of one head, as float32, into dst with stride ld;
// rows past n and columns past D are zero
template <typename T, int R, int Dp>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long ss, int row0, int n, int D) {
  for (int i = threadIdx.x; i < R * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    float x = 0.f;
    if (row0 + r < n && d < D) x = to_f(src[(long long)(row0 + r) * ss + d]);
    dst[r * ld + d] = x;
  }
}

// Whether a (q tile, k tile) pair holds a kept (q, k): q - k spans
// [q0 - (k1 - 1), (q1 - 1) - k0]; causal keeps q - k >= 0, the window
// keeps q - k < window.
__device__ __forceinline__ bool live(const Args& a, int q0, int q1, int k0,
                                     int k1) {
  if (a.causal && q1 - 1 - k0 < 0) return false;
  if (a.window > 0 && q0 - (k1 - 1) >= a.window) return false;
  return true;
}

__device__ __forceinline__ bool kept(const Args& a, int qp, int kp) {
  return !((a.causal && kp > qp) || (a.window > 0 && qp - kp >= a.window));
}

// delta[b, h, i] = sum_d do[b, i, h, d] o[b, i, h, d]: a warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(Args a, int B) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long nrows = (long long)B * a.Hq * a.Sq;
  if (row >= nrows) return;
  const int i = (int)(row % a.Sq);
  const long long bh = row / a.Sq;
  const int b = (int)(bh / a.Hq), h = (int)(bh % a.Hq);
  const T* o = static_cast<const T*>(a.o) + b * a.st[O][0] + h * a.st[O][1] +
               (long long)i * a.st[O][2];
  const T* g = static_cast<const T*>(a.dout) + b * a.st[DO][0] +
               h * a.st[DO][1] + (long long)i * a.st[DO][2];
  float s = 0.f;
  for (int d = lane; d < a.D; d += 32) s = fmaf(to_f(g[d]), to_f(o[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) a.delta[row] = s;
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Args a) {
  constexpr int Dp = DPT * 16;
  constexpr int ld = Dp + 1;
  constexpr int lds = kBKq + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kBQ * ld;            // do
  float* sK = sG + kBQ * ld;
  float* sV = sK + kBKq * ld;
  float* sS = sV + kBKq * ld;           // ds

  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int q1 = min(q0 + kBQ, a.Sq);
  const int tr = threadIdx.x >> 4;      // rows tr, tr + 16
  const int tc = threadIdx.x & 15;      // columns tc + 16 j

  const T* q = static_cast<const T*>(a.q) + b * a.st[Q][0] + h * a.st[Q][1];
  const T* g = static_cast<const T*>(a.dout) + b * a.st[DO][0] +
               h * a.st[DO][1];
  const T* k = static_cast<const T*>(a.k) + b * a.st[K][0] + hk * a.st[K][1];
  const T* v = static_cast<const T*>(a.v) + b * a.st[V][0] + hk * a.st[V][1];
  stage<T, kBQ, Dp>(sQ, ld, q, a.st[Q][2], q0, a.Sq, a.D);
  stage<T, kBQ, Dp>(sG, ld, g, a.st[DO][2], q0, a.Sq, a.D);

  const long long lrow = (long long)bh * a.Sq;
  float L[2], Dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + tr + 16 * i;
    L[i] = qp < a.Sq ? a.lse[lrow + qp] : 0.f;
    Dl[i] = qp < a.Sq ? a.delta[lrow + qp] : 0.f;
  }
  float acc[2][DPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const int nk = (a.Sk + kBKq - 1) / kBKq;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBKq;
    if (!live(a, q0, q1, k0, min(k0 + kBKq, a.Sk))) continue;
    __syncthreads();                    // the previous tile is consumed
    stage<T, kBKq, Dp>(sK, ld, k, a.st[K][2], k0, a.Sk, a.D);
    stage<T, kBKq, Dp>(sV, ld, v, a.st[V][2], k0, a.Sk, a.D);
    __syncthreads();

    float s[2][2], dp[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dp; ++d) {
      float qv[2], gv[2], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qv[i] = sQ[(tr + 16 * i) * ld + d];
        gv[i] = sG[(tr + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = sK[(tc + 16 * j) * ld + d];
        vv[j] = sV[(tc + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tc + 16 * j;
        float ds = 0.f;
        if (qp < a.Sq && kp < a.Sk) {
          const float x = kept(a, qp, kp) ? s[i][j] * a.scale : kMasked;
          const float p = expf(x - L[i]);
          ds = p * (dp[i][j] - Dl[i]);
        }
        sS[(tr + 16 * i) * lds + tc + 16 * j] = ds;
      }
    }
    __syncthreads();                    // ds complete

#pragma unroll 4
    for (int c = 0; c < kBKq; ++c) {
      float dsv[2], kv[DPT];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsv[i] = sS[(tr + 16 * i) * lds + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = sK[c * ld + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dq = static_cast<T*>(a.dq) + b * a.st[DQ][0] + h * a.st[DQ][1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + tr + 16 * i;
    if (qp >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tc + 16 * j;
      if (d < a.D)
        from_f(acc[i][j] * a.scale, dq + (long long)qp * a.st[DQ][2] + d);
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(Args a) {
  constexpr int Dp = DPT * 16;
  constexpr int ld = Dp + 1;
  constexpr int ldp = kBKk + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBKk * ld;
  float* sQ = sV + kBKk * ld;
  float* sG = sQ + kBQ * ld;            // do
  float* sP = sG + kBQ * ld;            // p, (q, k)
  float* sS = sP + kBQ * ldp;           // ds, (q, k)
  float* sL = sS + kBQ * ldp;
  float* sD = sL + kBQ;

  const int bhk = blockIdx.x;
  const int G = a.Hq / a.Hkv;
  const int b = bhk / a.Hkv, hk = bhk - b * a.Hkv;
  const int k0 = blockIdx.y * kBKk;
  const int k1 = min(k0 + kBKk, a.Sk);
  // scores: q row sr, k columns sc, sc + 8
  const int sr = threadIdx.x >> 3, sc = threadIdx.x & 7;
  // accumulators: k row ar, columns ac + 16 j
  const int ar = threadIdx.x >> 4, ac = threadIdx.x & 15;

  const T* k = static_cast<const T*>(a.k) + b * a.st[K][0] + hk * a.st[K][1];
  const T* v = static_cast<const T*>(a.v) + b * a.st[V][0] + hk * a.st[V][1];
  stage<T, kBKk, Dp>(sK, ld, k, a.st[K][2], k0, a.Sk, a.D);
  stage<T, kBKk, Dp>(sV, ld, v, a.st[V][2], k0, a.Sk, a.D);

  float dk[DPT], dv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk[j] = dv[j] = 0.f;

  const int nq = (a.Sq + kBQ - 1) / kBQ;
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const T* q = static_cast<const T*>(a.q) + b * a.st[Q][0] + h * a.st[Q][1];
    const T* g = static_cast<const T*>(a.dout) + b * a.st[DO][0] +
                 h * a.st[DO][1];
    const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kBQ;
      if (!live(a, q0, min(q0 + kBQ, a.Sq), k0, k1)) continue;
      __syncthreads();                  // the previous q tile is consumed
      stage<T, kBQ, Dp>(sQ, ld, q, a.st[Q][2], q0, a.Sq, a.D);
      stage<T, kBQ, Dp>(sG, ld, g, a.st[DO][2], q0, a.Sq, a.D);
      if (threadIdx.x < kBQ) {
        const int qp = q0 + threadIdx.x;
        sL[threadIdx.x] = qp < a.Sq ? a.lse[lrow + qp] : 0.f;
        sD[threadIdx.x] = qp < a.Sq ? a.delta[lrow + qp] : 0.f;
      }
      __syncthreads();

      float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < Dp; ++d) {
        const float qv = sQ[sr * ld + d], gv = sG[sr * ld + d];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[j] = fmaf(qv, sK[(sc + 8 * j) * ld + d], s[j]);
          dp[j] = fmaf(gv, sV[(sc + 8 * j) * ld + d], dp[j]);
        }
      }
      const int qp = q0 + sr;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + sc + 8 * j;
        float p = 0.f, ds = 0.f;
        if (qp < a.Sq && kp < a.Sk) {
          const float x = kept(a, qp, kp) ? s[j] * a.scale : kMasked;
          p = expf(x - sL[sr]);
          ds = p * (dp[j] - sD[sr]);
        }
        sP[sr * ldp + sc + 8 * j] = p;
        sS[sr * ldp + sc + 8 * j] = ds;
      }
      __syncthreads();                  // p and ds complete

#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        const float p = sP[r * ldp + ar], ds = sS[r * ldp + ar];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv[j] = fmaf(p, sG[r * ld + ac + 16 * j], dv[j]);
          dk[j] = fmaf(ds, sQ[r * ld + ac + 16 * j], dk[j]);
        }
      }
    }
  }

  const int kp = k0 + ar;
  if (kp >= a.Sk) return;
  T* dkp = static_cast<T*>(a.dk) + b * a.st[DK][0] + hk * a.st[DK][1] +
           (long long)kp * a.st[DK][2];
  T* dvp = static_cast<T*>(a.dv) + b * a.st[DV][0] + hk * a.st[DV][1] +
           (long long)kp * a.st[DV][2];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = ac + 16 * j;
    if (d < a.D) {
      from_f(dk[j] * a.scale, dkp + d);
      from_f(dv[j], dvp + d);
    }
  }
}

template <int DPT>
constexpr int smem_dq() {
  return ((2 * kBQ + 2 * kBKq) * (DPT * 16 + 1) + kBQ * (kBKq + 1)) *
         (int)sizeof(float);
}

template <int DPT>
constexpr int smem_dkdv() {
  return ((2 * kBKk + 2 * kBQ) * (DPT * 16 + 1) + 2 * kBQ * (kBKk + 1) +
          2 * kBQ) * (int)sizeof(float);
}

template <typename T, int DPT>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  constexpr int sq = smem_dq<DPT>(), sk = smem_dkdv<DPT>();
  static bool attr_set = false;         // once per instance and process
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, sq);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DPT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 sk);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long rows = (long long)B * a.Hq * a.Sq;
  const unsigned dblocks = (unsigned)((rows + kThreads / 32 - 1) /
                                      (kThreads / 32));
  flash_bwd_delta<T><<<dblocks, kThreads, 0, st>>>(a, B);
  const dim3 gq((unsigned)(B * a.Hq), (unsigned)((a.Sq + kBQ - 1) / kBQ));
  flash_bwd_dq<T, DPT><<<gq, kThreads, sq, st>>>(a);
  const dim3 gk((unsigned)(B * a.Hkv), (unsigned)((a.Sk + kBKk - 1) / kBKk));
  flash_bwd_dkdv<T, DPT><<<gk, kThreads, sk, st>>>(a);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 16) return launch<T, 1>(a, B, st);
  if (a.D <= 32) return launch<T, 2>(a, B, st);
  if (a.D <= 64) return launch<T, 4>(a, B, st);
  if (a.D <= 128) return launch<T, 8>(a, B, st);
  return launch<T, 16>(a, B, st);
}

}  // namespace

extern "C" {

// ptrs: q, k, v, o, do, lse, delta, dq, dk, dv on the current device;
// strides: 8 x 3 element strides (batch, head, sequence) of q, k, v, o, do,
// dq, dk, dv, the last dimension of each contiguous. q, k, v, o, do, dq, dk,
// dv share one dtype (0 = float32, 1 = bfloat16); lse (B, Hq, Sq) float32
// is the forward's, delta (B, Hq, Sq) float32 is scratch. 1 <= D <= 256,
// Hq a multiple of Hkv, B * Hq < 2^31, Sq < 2^21, Sk < 2^20. Launches the
// three kernels on `stream` and returns cudaGetLastError() (0 on success);
// it never synchronises.
int flash_attention_bwd(void* const* ptrs, int B, int Hq, int Hkv, int Sq,
                        int Sk, int D, const long long* strides, int causal,
                        int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 1 || D > 256 ||
      (long long)B * Hq > 0x7fffffffLL || Sq > 65535 * kBQ ||
      Sk > 65535 * kBKk)
    return (int)cudaErrorInvalidValue;
  Args a{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4],
         static_cast<const float*>(ptrs[5]), static_cast<float*>(ptrs[6]),
         ptrs[7], ptrs[8], ptrs[9], Hq, Hkv, Sq, Sk, D, {},
         causal, window, scale};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(a, B, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(a, B, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
