// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel). For q (B, Hq, Sq, D) and k, v
// (B, Hkv, Sk, D), float32 or bfloat16, with q head h reading kv head
// h / (Hq / Hkv) (GQA, MQA at Hkv = 1):
//
//   o[q] = sum_k softmax_k(s[q, k]) v[k],  s = scale * q . k
//
// with the causal mask (k <= q) and the window mask (q - k < window) by
// index. On request it also writes each row's log-sum-exp of the scaled
// scores, lse = m + log l (B, Hq, Sq) float32, which the backward
// (csrc/flash_attention_bwd.cu) recomputes p from; o is the same with or
// without it. A masked score is -1e30, as in the TPU kernel and the plain
// version (a row with no valid key at all averages v); a key past Sk does
// not count at all. All arithmetic is float32: operands are widened as they
// are staged, the online-softmax state (m, l, acc) is float32, and the
// output is rounded once to q's dtype.
//
// Design (simple and right first; speed is later work):
//  * one block of 256 threads per (batch * q head, 64-row q tile); a loop
//    inside the block walks the 64-row k tiles in order, in place of the TPU
//    kernel's sequential grid dimension, and skips the tiles that the causal
//    or window mask leaves fully masked (the TPU kernel's conditions);
//  * the q tile, one k tile, one v tile and the 64 x 64 probability tile
//    sit in dynamic shared memory as float32, rows padded by one word so the
//    column reads below hit distinct banks: (3 * 64 * (Dp + 1) + 64 * 65) * 4
//    bytes, 214,016 at D = 256, above the 48 KB default and so set with
//    cudaFuncSetAttribute;
//  * thread (tr, tc) of a 16 x 16 grid owns rows tr + 16 i (i < 4): it
//    computes the scores of those rows at columns tc + 16 j (j < 4) with
//    FMAs over d from shared memory (QK^T), reduces each row's max and sum
//    over the 16 lanes of its half-warp with shuffles, writes the
//    probabilities to shared memory, then accumulates P V into its rows at
//    columns tc + 16 jd (jd < Dp / 16) of the output, all in registers;
//  * inputs are read through strides (batch, head, sequence; d contiguous),
//    so the model's (B, S, H, D) tensors need no transpose; the ragged q
//    and k tails are masked, and D up to 256 is padded to a multiple of 16
//    with zeros.
//
// What bounds it on an H100 SXM: at the encoder's shape, (64, 10 / 1, 48,
// 256) bf16 causal, the function moves ~35 MB (~10 us at 3.35 TB/s) and
// does ~0.75 GFLOP; this kernel does its products on the FMA units out of
// shared memory (8 shared loads per 16 FMAs in QK^T), so it is bound by
// shared-memory bandwidth, far above both. Tensor-core tiles (mma.sync /
// wgmma on bf16 operands) and TMA staging are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // q rows per block
constexpr int kBK = 64;               // k rows per tile
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                          // (B, Hq, Sq) or null
  int Hq, Hkv, Sq, Sk, D;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + 64) of one head, as float32, into dst with stride ld;
// rows past n and columns past D are zero
template <typename T, int Dp>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long ss, int row0, int n, int D) {
  for (int i = threadIdx.x; i < kBQ * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    float x = 0.f;
    if (row0 + r < n && d < D) x = to_f(src[(long long)(row0 + r) * ss + d]);
    dst[r * ld + d] = x;
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  constexpr int Dp = DPT * 16;
  constexpr int ld = Dp + 1;
  constexpr int ldp = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * ld;
  float* sV = sK + kBK * ld;
  float* sP = sV + kBK * ld;

  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = warp * 2 + (lane >> 4);   // row group 0..15
  const int tc = lane & 15;                // column group 0..15

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  stage<T, Dp>(sQ, ld, q, a.q_ss, q0, a.Sq, a.D);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int nk = (a.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    // the TPU kernel's skip rule: k tile entirely after the q tile, or
    // entirely before the window of its first row
    if (a.causal && k0 >= q0 + kBQ) break;
    if (a.causal && a.window > 0 && k0 + kBK <= q0 - a.window) continue;
    __syncthreads();                       // the previous tile is consumed
    stage<T, Dp>(sK, ld, k, a.k_ss, k0, a.Sk, a.D);
    stage<T, Dp>(sV, ld, v, a.v_ss, k0, a.Sk, a.D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dp; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tc + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        float x = s[i][j] * a.scale;
        if (kp >= a.Sk) {
          x = -INFINITY;                   // past the end: no weight at all
        } else if ((a.causal && kp > qp) ||
                   (a.window > 0 && qp - kp >= a.window)) {
          x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(tr + 16 * i) * ldp + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                       // P complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(tr + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sV[c * ld + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tr + 16 * i;
    if (qp >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (a.lse != nullptr && tc == 0)
      a.lse[(long long)bh * a.Sq + qp] = m[i] + logf(den);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tc + 16 * j;
      if (d < a.D) from_f(acc[i][j] / den, o + (long long)qp * a.o_ss + d);
    }
  }
}

template <int DPT>
constexpr int smem_bytes() {
  return (3 * kBQ * (DPT * 16 + 1) + kBQ * (kBK + 1)) * (int)sizeof(float);
}

template <typename T, int DPT>
cudaError_t launch(const Args& a, int BH, cudaStream_t st) {
  constexpr int smem = smem_bytes<DPT>();
  static bool attr_set = false;            // once per instance and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((unsigned)BH, (unsigned)((a.Sq + kBQ - 1) / kBQ));
  flash_fwd<T, DPT><<<grid, kThreads, smem, st>>>(a);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const Args& a, int BH, cudaStream_t st) {
  if (a.D <= 16) return launch<T, 1>(a, BH, st);
  if (a.D <= 32) return launch<T, 2>(a, BH, st);
  if (a.D <= 64) return launch<T, 4>(a, BH, st);
  if (a.D <= 128) return launch<T, 8>(a, BH, st);
  return launch<T, 16>(a, BH, st);
}

}  // namespace

extern "C" {

// q, k, v, o on the current device, element strides (batch, head, sequence)
// for each, the last dimension contiguous; o takes q's shape and dtype; lse
// is null or a contiguous (B, Hq, Sq) float32 output.
// dtype 0 = float32, 1 = bfloat16 (q, k, v and o alike). 1 <= D <= 256,
// Hq a multiple of Hkv, B * Hq < 2^31, Sq < 2^22. Launches on `stream` and
// returns cudaGetLastError() (0 on success); it never synchronises.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                        int D, const long long* strides, int causal,
                        int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 1 || D > 256 || Sk <= 0 ||
      (long long)B * Hq > 0x7fffffffLL || Sq > (65535 * kBQ))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, lse, Hq, Hkv, Sq, Sk, D,
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         strides[10], strides[11], causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(a, B * Hq, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(a, B * Hq, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
