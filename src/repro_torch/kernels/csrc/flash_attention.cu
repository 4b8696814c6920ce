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
// not count at all. The online-softmax state (m, l, o) is float32 and the
// output is rounded once to q's dtype. Both routes walk the 64-row k tiles
// of their 64-row q tile in order, in place of the TPU kernel's sequential
// grid dimension, and skip the tiles that the causal or window mask leaves
// fully masked (the TPU kernel's conditions). Operands are read through
// strides (batch, head, sequence; d contiguous), so the model's (B, S, H,
// D) tensors need no transpose.
//
// bfloat16 (flash_fwd_mma), the route of every call of the model:
//  * one block of 4 warps per (batch * q head, 64-row q tile), the tiles
//    with the most k tiles first; warp w owns q rows 16 w .. 16 w + 15 and
//    keeps their running max and sum and their 16 x D float32 output in
//    registers (D / 2 floats a thread), so no reduction crosses warps: a
//    row's max and sum reduce over the 4 lanes of a quad with shuffles;
//  * QK^T and PV run on the tensor cores as mma.sync m16n8k16 bf16 ->
//    float32, operands by ldmatrix (.trans for V) from shared memory whose
//    rows are padded by 16 bytes, so ldmatrix is free of bank conflicts;
//    the scores, rounded to bf16, are PV's A operand straight from the
//    registers (the accumulator layout is the A layout);
//  * q (64 x D) is staged once; k and v tiles of 64 rows stream by 16-byte
//    cp.async copies, v's load overlapping QK^T and the next k's load
//    overlapping PV (FlashAttention-2's order): 3 x 64 x (D + 8) x 2 bytes,
//    101,376 at D = 256, so two blocks fit an SM; rows past Sq / Sk and
//    columns past D are zero-filled, and operands whose base or row stride
//    is not 16-byte aligned are staged element by element instead;
//  * the element mask runs only on tiles that straddle the causal
//    diagonal, the window edge or the Sk tail for the warp's rows;
//    exponentials are exp2 of scores scaled by scale * log2(e);
//  * the output, divided by max(l, 1e-30), is rounded to bf16 once, staged
//    through the warp's own q rows and stored with 16-byte stores.
// The products of two bf16 values are exact in float32, so the scores equal
// the float32 reference's up to summation order; the kernel departs from it
// only where p is rounded to bf16 as PV's operand.
//
// float32 (flash_fwd): one block of 256 threads per (batch * q head, 64-row
// q tile); the q, k, v and probability tiles sit in shared memory as
// float32, rows padded by one word, 214,016 bytes at D = 256, and both
// products are FMAs out of shared memory (a 16 x 16 thread grid, 4 x 4
// scores a thread). Kept as it was: TF32 tensor cores would not hold the
// float32 gates.
//
// What bounds it on an H100 SXM: at the encoder's shape, (64, 10 / 1, 48,
// 256) bf16 causal, the function moves ~35 MB (~10 us at 3.35 TB/s) and
// does ~0.75 GFLOP; at the training shape (4, 10 / 1, 512, 256) 23 MB
// (6.9 us) against 5.4 GFLOP (5.4 us at 989 TFLOP/s), so both are bound by
// bytes; at 4096 tokens with the 2048 window, 64 GFLOP bind it (65 us).
// mma.sync reads each operand fragment through ldmatrix from shared memory
// for every product, so the bf16 kernel is bound by shared-memory bandwidth
// at about twice its tensor-core time; wgmma with TMA staging and a
// producer warp is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_cache.cuh"
#include "mma_bf16.cuh"

namespace {

using mma::bf16;

constexpr int kBQ = 64;               // q rows per block
constexpr int kBK = 64;               // k rows per tile
constexpr int kThreads = 256;         // float32 route
constexpr int kMmaThreads = 128;      // bfloat16 route
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
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

// The k tiles [lo, hi) that a q tile starting at q0 visits: the TPU
// kernel's skip rule drops a k tile entirely after the q tile, or entirely
// before the window of its first row.
__device__ __forceinline__ void k_range(const Args& a, int q0, int& lo,
                                        int& hi) {
  hi = (a.Sk + kBK - 1) / kBK;
  if (a.causal) hi = min(hi, q0 / kBK + 1);
  lo = 0;
  if (a.causal && a.window > 0 && q0 - a.window - kBK >= 0)
    lo = (q0 - a.window - kBK) / kBK + 1;
}

// rows [row0, row0 + 64) of one head, as float32, into dst with stride ld;
// rows past n and columns past D are zero
template <int Dp>
__device__ __forceinline__ void stage_f32(float* dst, int ld,
                                          const float* src, long long ss,
                                          int row0, int n, int D) {
  for (int i = threadIdx.x; i < kBQ * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    float x = 0.f;
    if (row0 + r < n && d < D) x = src[(long long)(row0 + r) * ss + d];
    dst[r * ld + d] = x;
  }
}

template <int DPT>
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

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb +
                   hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb +
                   hk * a.v_sh;
  stage_f32<Dp>(sQ, ld, q, a.q_ss, q0, a.Sq, a.D);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int kt_lo, kt_hi;
  k_range(a, q0, kt_lo, kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                       // the previous tile is consumed
    stage_f32<Dp>(sK, ld, k, a.k_ss, k0, a.Sk, a.D);
    stage_f32<Dp>(sV, ld, v, a.v_ss, k0, a.Sk, a.D);
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

  float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
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
      if (d < a.D) o[(long long)qp * a.o_ss + d] = acc[i][j] / den;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_fwd_mma(Args a, int vec) {
  constexpr int LD = DP + 8;
  constexpr int NJ = kBK / 8;              // score n-tiles of a k tile
  constexpr int ND = DP / 8;               // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * LD;
  bf16* sV = sK + kBK * LD;

  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + 16 * warp;           // the warp's first row
  const bool active = qw < a.Sq;
  const float sl2 = a.scale * kLog2e;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;

  int kt_lo, kt_hi;
  k_range(a, q0, kt_lo, kt_hi);
  mma::stage<kBQ, DP, LD, kMmaThreads>(sQ, q, a.q_ss, q0, a.Sq, a.D, vec,
                                       threadIdx.x);
  if (kt_lo < kt_hi)
    mma::stage<kBK, DP, LD, kMmaThreads>(sK, k, a.k_ss, kt_lo * kBK, a.Sk,
                                         a.D, vec, threadIdx.x);
  mma::cp_commit();

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    mma::stage<kBK, DP, LD, kMmaThreads>(sV, v, a.v_ss, k0, a.Sk, a.D, vec,
                                         threadIdx.x);
    mma::cp_commit();
    mma::cp_wait<1>();                     // q and this k tile have landed
    __syncthreads();

    uint32_t pa[kBK / 16][4];              // p as PV's A operand
    if (active) {
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qa[4];
        mma::ldsm_x4(qa, mma::a_addr(sQ, LD, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          uint32_t kb[4];
          mma::ldsm_x4(kb, mma::bn_addr(sK, LD, 16 * jp, 16 * kk, lane));
          mma::mma16816(s[2 * jp], qa, kb[0], kb[1]);
          mma::mma16816(s[2 * jp + 1], qa, kb[2], kb[3]);
        }
      }
      // the element mask only where the tile is not fully kept for all of
      // the warp's rows
      const bool full = k0 + kBK <= a.Sk &&
                        (!a.causal || k0 + kBK - 1 <= qw) &&
                        (a.window <= 0 || qw + 15 - k0 < a.window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * sl2;
          if (!full) {
            const int qp = qw + g + 8 * (e >> 1);
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            if (kp >= a.Sk) {
              x = -INFINITY;               // past the end: no weight at all
            } else if ((a.causal && kp > qp) ||
                       (a.window > 0 && qp - kp >= a.window)) {
              x = kMasked;
            }
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;                  // this lane's share of the row
          s[j][e] = p;
        }
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = mma::pack(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = mma::pack(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = mma::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = mma::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    }
    mma::cp_wait<0>();                     // this v tile has landed
    __syncthreads();                       // and every warp is done with k
    if (kt + 1 < kt_hi)
      mma::stage<kBK, DP, LD, kMmaThreads>(sK, k, a.k_ss, k0 + kBK, a.Sk,
                                           a.D, vec, threadIdx.x);
    mma::cp_commit();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t vb[4];
          mma::ldsm_x4_t(vb, mma::bt_addr(sV, LD, 16 * kk, 16 * dp, lane));
          mma::mma16816(acc[2 * dp], pa[kk], vb[0], vb[1]);
          mma::mma16816(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
        }
    }
    __syncthreads();                       // every warp is done with v
  }
  mma::cp_wait<0>();

  // the row sums over the quad, then o / l rounded once to bf16 into the
  // warp's own q rows (no other warp reads them), stored 16 bytes a lane
  bf16* o = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const float den = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / den;
    const int qp = qw + g + 8 * r;
    if (a.lse != nullptr && t == 0 && qp < a.Sq)
      a.lse[(long long)bh * a.Sq + qp] = (m[r] + log2f(den)) / kLog2e;
  }
  bf16* sO = sQ + 16 * warp * LD;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(sO + (g + 8 * r) * LD + 8 * j + 2 * t) =
          mma::pack(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
  __syncwarp();
  mma::store<16, DP, LD, 32>(o, a.o_ss, qw, a.Sq, a.D, sO, lane, vec);
}


template <int DPT>
constexpr int smem_bytes() {
  return (3 * kBQ * (DPT * 16 + 1) + kBQ * (kBK + 1)) * (int)sizeof(float);
}

template <int DP>
constexpr int smem_mma() {
  return (kBQ + 2 * kBK) * (DP + 8) * (int)sizeof(bf16);
}

template <int DPT>
cudaError_t launch(const Args& a, int BH, cudaStream_t st) {
  constexpr int smem = smem_bytes<DPT>();
  const cudaError_t err = launch_cache::allow_smem(flash_fwd<DPT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)BH, (unsigned)((a.Sq + kBQ - 1) / kBQ));
  flash_fwd<DPT><<<grid, kThreads, smem, st>>>(a);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_mma(const Args& a, int BH, int vec, cudaStream_t st) {
  constexpr int smem = smem_mma<DP>();
  const cudaError_t err = launch_cache::allow_smem(flash_fwd_mma<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)BH, (unsigned)((a.Sq + kBQ - 1) / kBQ));
  flash_fwd_mma<DP><<<grid, kMmaThreads, smem, st>>>(a, vec);
  return cudaSuccess;
}

cudaError_t dispatch_f32(const Args& a, int BH, cudaStream_t st) {
  if (a.D <= 16) return launch<1>(a, BH, st);
  if (a.D <= 32) return launch<2>(a, BH, st);
  if (a.D <= 64) return launch<4>(a, BH, st);
  if (a.D <= 128) return launch<8>(a, BH, st);
  return launch<16>(a, BH, st);
}

cudaError_t dispatch_bf16(const Args& a, int BH, int vec, cudaStream_t st) {
  if (a.D <= 32) return launch_mma<32>(a, BH, vec, st);
  if (a.D <= 64) return launch_mma<64>(a, BH, vec, st);
  if (a.D <= 128) return launch_mma<128>(a, BH, vec, st);
  return launch_mma<256>(a, BH, vec, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  if (dtype == 0) {
    err = dispatch_f32(a, B * Hq, st);
  } else if (dtype == 1) {
    // 16-byte copies need 16-byte aligned rows: every base and stride
    bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
    for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 8 == 0;
    err = dispatch_bf16(a, B * Hq, vec ? 1 : 0, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
