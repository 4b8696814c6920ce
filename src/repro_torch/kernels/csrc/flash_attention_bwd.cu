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
// head sum over its G query heads. Differences such as dp - delta are
// float32; the outputs are rounded once to q's dtype. No kernel uses
// atomics, so a run repeats bit for bit. flash_bwd_delta, delta =
// rowsum(do o) with one warp per row, comes first on both routes.
//
// bfloat16, the route of every call of the model: three tensor-core
// kernels (mma.sync m16n8k16 bf16 -> float32, operands by ldmatrix from
// shared memory with rows padded by 16 bytes, tiles staged by 16-byte
// cp.async copies through 2-stage rings, or element by element where a
// base or row stride is not 16-byte aligned), each of 8 warps as 4 row
// groups x 2 halves:
//  * flash_bwd_dq_mma: one block per (batch * q head, 64-row q tile), the
//    tiles with the most k tiles first. q, do, lse and delta stay; the live
//    64-row k and v tiles stream. Per k tile it recomputes s = q k^T and
//    dp = do v^T (each warp a 16 x 32 block), writes ds = p (dp - delta)
//    as bf16 to shared memory, and accumulates dq += ds k (each warp 16
//    rows x D / 2, in registers);
//  * flash_bwd_dkdv_mma: one block per (batch * kv head, 64-row k tile,
//    group of the kv head's query heads). k and v stay; q, do, lse and
//    delta of the group's live (head, q tile) pairs stream. Per q tile it
//    recomputes s^T = k q^T and dp^T = v do^T, writes p^T and ds^T as bf16
//    to shared memory, and accumulates dv += p^T do and dk += ds^T q (each
//    warp 16 rows x D / 2 of both, 128 floats a thread at D = 256). The G
//    query heads are split into nsplit groups, enough that the grid holds a
//    block per SM (B * Hkv * ceil(Sk / 64) blocks a group): at the training
//    shape, 4 x 512 tokens with G = 10 over one kv head, 32 k tiles x 5
//    groups of 2 heads = 160 blocks. With one group a block writes dk and
//    dv; with more, float32 partials into scratch that the caller sizes by
//    flash_attention_bwd_scratch;
//  * flash_bwd_reduce: sums the partials in group order, scales dk and
//    rounds both to bf16.
// Shared memory at D = 256: 211,968 bytes for dq (q, do, two k / v stages,
// ds) and 222,208 for dk/dv (k, v, two q / do / lse / delta stages, p^T,
// ds^T), set with cudaFuncSetAttribute. dq repeats the two score products
// that dk/dv computes: seven products in all instead of five, the price of
// no atomics. The products of two bf16 values are exact in float32; the
// kernels depart from the float32 reference only where p and ds are
// rounded to bf16 as operands.
//
// float32, kept as it was (TF32 would not hold the float32 gates):
//  * flash_bwd_dq: one block of 256 threads per (batch * q head, 32-row q
//    tile); it keeps q, do, lse and delta of its tile, walks the 32-row k
//    tiles that hold a kept (q, k) pair (causal and window by index, as the
//    forward skips), recomputes p and ds, and accumulates dq in registers;
//  * flash_bwd_dkdv: one block per (batch * kv head, 16-row k tile); it keeps
//    k and v of its tile, walks the G query heads and, for each, the 32-row
//    q tiles with a kept pair, and accumulates dk and dv in registers.
// Tiles sit in dynamic shared memory as float32 rows padded by one word,
// 135,808 and 103,296 bytes at D = 256; products are FMAs out of shared
// memory, as in the forward.
//
// What bounds it on an H100 SXM: at the training shape, (4, 10 / 1, 512,
// 256) bf16 causal, the function reads q, k, v, o, do and lse once and
// writes dq, dk, dv (46 MB, 13.8 us at 3.35 TB/s) and does 5 products of
// 2 D flops over the 5.25 M kept pairs (13.4 GFLOP, 13.6 us at the bf16
// tensor-core rate), so it is bound by bytes, barely. The bf16 kernels
// read every operand fragment through ldmatrix from shared memory, so they
// are bound by shared-memory bandwidth at two to three times their
// tensor-core time; wgmma with TMA staging and a producer warp is the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_cache.cuh"
#include "mma_bf16.cuh"

namespace {

using mma::bf16;

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
  float* part;                          // bf16 dk/dv partials, or null
  int nsplit;                           // query-head groups per kv head
  int vec;                              // rows 16-byte aligned
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows [row0, row0 + R) of one head, as float32, into dst with stride ld;
// rows past n and columns past D are zero
template <int R, int Dp>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long ss, int row0, int n, int D) {
  for (int i = threadIdx.x; i < R * Dp; i += kThreads) {
    const int r = i / Dp, d = i - r * Dp;
    float x = 0.f;
    if (row0 + r < n && d < D) x = src[(long long)(row0 + r) * ss + d];
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

template <int DPT>
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

  const float* q = static_cast<const float*>(a.q) + b * a.st[Q][0] +
                   h * a.st[Q][1];
  const float* g = static_cast<const float*>(a.dout) + b * a.st[DO][0] +
                   h * a.st[DO][1];
  const float* k = static_cast<const float*>(a.k) + b * a.st[K][0] +
                   hk * a.st[K][1];
  const float* v = static_cast<const float*>(a.v) + b * a.st[V][0] +
                   hk * a.st[V][1];
  stage<kBQ, Dp>(sQ, ld, q, a.st[Q][2], q0, a.Sq, a.D);
  stage<kBQ, Dp>(sG, ld, g, a.st[DO][2], q0, a.Sq, a.D);

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
    stage<kBKq, Dp>(sK, ld, k, a.st[K][2], k0, a.Sk, a.D);
    stage<kBKq, Dp>(sV, ld, v, a.st[V][2], k0, a.Sk, a.D);
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

  float* dq = static_cast<float*>(a.dq) + b * a.st[DQ][0] + h * a.st[DQ][1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + tr + 16 * i;
    if (qp >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tc + 16 * j;
      if (d < a.D)
        dq[(long long)qp * a.st[DQ][2] + d] = acc[i][j] * a.scale;
    }
  }
}

template <int DPT>
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

  const float* k = static_cast<const float*>(a.k) + b * a.st[K][0] +
                   hk * a.st[K][1];
  const float* v = static_cast<const float*>(a.v) + b * a.st[V][0] +
                   hk * a.st[V][1];
  stage<kBKk, Dp>(sK, ld, k, a.st[K][2], k0, a.Sk, a.D);
  stage<kBKk, Dp>(sV, ld, v, a.st[V][2], k0, a.Sk, a.D);

  float dk[DPT], dv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk[j] = dv[j] = 0.f;

  const int nq = (a.Sq + kBQ - 1) / kBQ;
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const float* q = static_cast<const float*>(a.q) + b * a.st[Q][0] +
                     h * a.st[Q][1];
    const float* g = static_cast<const float*>(a.dout) + b * a.st[DO][0] +
                     h * a.st[DO][1];
    const long long lrow = ((long long)b * a.Hq + h) * a.Sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kBQ;
      if (!live(a, q0, min(q0 + kBQ, a.Sq), k0, k1)) continue;
      __syncthreads();                  // the previous q tile is consumed
      stage<kBQ, Dp>(sQ, ld, q, a.st[Q][2], q0, a.Sq, a.D);
      stage<kBQ, Dp>(sG, ld, g, a.st[DO][2], q0, a.Sq, a.D);
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
  float* dkp = static_cast<float*>(a.dk) + b * a.st[DK][0] + hk * a.st[DK][1] +
           (long long)kp * a.st[DK][2];
  float* dvp = static_cast<float*>(a.dv) + b * a.st[DV][0] + hk * a.st[DV][1] +
           (long long)kp * a.st[DV][2];
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = ac + 16 * j;
    if (d < a.D) {
      dkp[d] = dk[j] * a.scale;
      dvp[d] = dv[j];
    }
  }
}

// ---- bfloat16: tensor-core kernels ----------------------------------------

constexpr int kT = 64;                // q and k rows per tile
constexpr int kMmaThreads = 256;      // 8 warps: 4 row groups x 2 halves
constexpr int kLDS = kT + 8;          // row stride of the p and ds tiles
constexpr float kLog2e = 1.4426950408889634f;

// The live tiles [lo, hi) of kT rows along an axis of n rows, against the
// fixed range [f0, f1) of the other axis (q_axis: the tiles are q tiles
// and the fixed range is keys; else the reverse). Live tiles are
// contiguous: the kept q - k lie in [0, window).
__device__ __forceinline__ void live_range(const Args& a, bool q_axis, int n,
                                           int f0, int f1, int& lo,
                                           int& hi) {
  const int nt = (n + kT - 1) / kT;
  auto is_live = [&](int i) {
    const int t0 = i * kT, t1 = min(t0 + kT, n);
    return q_axis ? live(a, t0, t1, f0, f1) : live(a, f0, f1, t0, t1);
  };
  lo = 0;
  while (lo < nt && !is_live(lo)) ++lo;
  hi = nt;
  while (hi > lo && !is_live(hi - 1)) --hi;
}

// A warp's 16 x 32 block of x = A1 B1^T and y = A2 B2^T over DP columns:
// rows r0.. of the A tiles against rows c0.. of the B tiles (all row-major
// bf16 tiles in shared memory with row stride LD).
template <int DP, int LD>
__device__ __forceinline__ void two_products(float (&x)[4][4],
                                             float (&y)[4][4],
                                             const bf16* a1, const bf16* b1,
                                             const bf16* a2, const bf16* b2,
                                             int r0, int c0, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t f1[4], f2[4];
    mma::ldsm_x4(f1, mma::a_addr(a1, LD, r0, 16 * kk, lane));
    mma::ldsm_x4(f2, mma::a_addr(a2, LD, r0, 16 * kk, lane));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t fb[4];
      mma::ldsm_x4(fb, mma::bn_addr(b1, LD, c0 + 16 * jp, 16 * kk, lane));
      mma::mma16816(x[2 * jp], f1, fb[0], fb[1]);
      mma::mma16816(x[2 * jp + 1], f1, fb[2], fb[3]);
      mma::ldsm_x4(fb, mma::bn_addr(b2, LD, c0 + 16 * jp, 16 * kk, lane));
      mma::mma16816(y[2 * jp], f2, fb[0], fb[1]);
      mma::mma16816(y[2 * jp + 1], f2, fb[2], fb[3]);
    }
  }
}

// acc (16 rows r0.. x DP / 2 columns c0..) += A B for the 16 x 64 bf16 A
// at rows r0.. of sa (row stride kLDS) and the 64 x DP / 2 bf16 B at
// columns c0.. of sb (storage [k][n], row stride LD)
template <int DP, int LD>
__device__ __forceinline__ void acc_product(float (&acc)[DP / 16][4],
                                            const bf16* sa, const bf16* sb,
                                            int r0, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    uint32_t fa[4];
    mma::ldsm_x4(fa, mma::a_addr(sa, kLDS, r0, 16 * kk, lane));
#pragma unroll
    for (int dp = 0; dp < DP / 32; ++dp) {
      uint32_t fb[4];
      mma::ldsm_x4_t(fb, mma::bt_addr(sb, LD, 16 * kk, c0 + 16 * dp, lane));
      mma::mma16816(acc[2 * dp], fa, fb[0], fb[1]);
      mma::mma16816(acc[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// a warp's 16 x 32 float32 block, rounded to bf16, into rows r0.., columns
// c0.. of a tile with row stride ld
__device__ __forceinline__ void put16x32(bf16* s, int ld, int r0, int c0,
                                         const float (&x)[4][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(s + (r0 + g + 8 * r) * ld + c0 + 8 * j +
                                   2 * t) =
          mma::pack(x[j][2 * r], x[j][2 * r + 1]);
}

// a warp's 16 x DP / 2 float32 accumulator times f, rounded to bf16, into
// rows r0.., columns c0.. of a tile with row stride ld
template <int DP>
__device__ __forceinline__ void put_acc(bf16* s, int ld, int r0, int c0,
                                        const float (&acc)[DP / 16][4],
                                        float f, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(s + (r0 + g + 8 * r) * ld + c0 + 8 * j +
                                   2 * t) =
          mma::pack(acc[j][2 * r] * f, acc[j][2 * r + 1] * f);
}

// dq for one (batch * q head, 64-row q tile): q, do, lse and delta stay;
// the live k and v tiles stream through a 2-stage cp.async ring. Per k
// tile, warp (wr, wc) recomputes s and dp for q rows 16 wr.. and keys
// 32 wc.., writes ds = p (dp - delta) as bf16 to shared memory, and then
// accumulates dq (rows 16 wr.., columns wc D / 2..) += ds k.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 1) flash_bwd_dq_mma(Args a) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + kT * LD;              // do
  bf16* sKV = sG + kT * LD;             // stage s: k at 2 s, v at 2 s + 1
  bf16* sS = sKV + 4 * kT * LD;         // ds, (q, k)

  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh - b * a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;  // most k tiles first
  const int q1 = min(q0 + kT, a.Sq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const float sl2 = a.scale * kLog2e;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.st[Q][0] +
                  h * a.st[Q][1];
  const bf16* gq = static_cast<const bf16*>(a.dout) + b * a.st[DO][0] +
                   h * a.st[DO][1];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.st[K][0] +
                  hk * a.st[K][1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.st[V][0] +
                  hk * a.st[V][1];
  float L2[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + 16 * wr + g + 8 * r;
    L2[r] = qp < a.Sq ? a.lse[(long long)bh * a.Sq + qp] * kLog2e : 0.f;
    Dl[r] = qp < a.Sq ? a.delta[(long long)bh * a.Sq + qp] : 0.f;
  }

  int lo, hi;
  live_range(a, false, a.Sk, q0, q1, lo, hi);
  auto load_kv = [&](int kt, int s) {
    bf16* d = sKV + 2 * s * kT * LD;
    mma::stage<kT, DP, LD, kMmaThreads>(d, k, a.st[K][2], kt * kT, a.Sk,
                                        a.D, a.vec, threadIdx.x);
    mma::stage<kT, DP, LD, kMmaThreads>(d + kT * LD, v, a.st[V][2], kt * kT,
                                        a.Sk, a.D, a.vec, threadIdx.x);
  };
  mma::stage<kT, DP, LD, kMmaThreads>(sQ, q, a.st[Q][2], q0, a.Sq, a.D,
                                      a.vec, threadIdx.x);
  mma::stage<kT, DP, LD, kMmaThreads>(sG, gq, a.st[DO][2], q0, a.Sq, a.D,
                                      a.vec, threadIdx.x);
  if (lo < hi) load_kv(lo, 0);
  mma::cp_commit();

  float acc[DP / 16][4];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int s = (kt - lo) & 1, k0 = kt * kT;
    const bf16* cK = sKV + 2 * s * kT * LD;
    const bf16* cV = cK + kT * LD;
    if (kt + 1 < hi) load_kv(kt + 1, s ^ 1);
    mma::cp_commit();
    mma::cp_wait<1>();                  // this stage has landed
    __syncthreads();

    float x[4][4], y[4][4];
    two_products<DP, LD>(x, y, sQ, cK, sG, cV, 16 * wr, 32 * wc, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + 16 * wr + g + 8 * (e >> 1);
        const int kp = k0 + 32 * wc + 8 * j + 2 * t + (e & 1);
        float ds = 0.f;
        if (qp < a.Sq && kp < a.Sk) {
          const float xs = kept(a, qp, kp) ? x[j][e] * sl2 : kMasked;
          ds = exp2f(xs - L2[e >> 1]) * (y[j][e] - Dl[e >> 1]);
        }
        x[j][e] = ds;
      }
    put16x32(sS, kLDS, 16 * wr, 32 * wc, x, lane);
    __syncthreads();                    // ds complete
    acc_product<DP, LD>(acc, sS, cK, 16 * wr, wc * (DP / 2), lane);
    __syncthreads();                    // this stage and ds are consumed
  }
  mma::cp_wait<0>();
  __syncthreads();

  put_acc<DP>(sQ, LD, 16 * wr, wc * (DP / 2), acc, a.scale, lane);
  __syncthreads();
  bf16* dq = static_cast<bf16*>(a.dq) + b * a.st[DQ][0] + h * a.st[DQ][1];
  mma::store<kT, DP, LD, kMmaThreads>(dq, a.st[DQ][2], q0, a.Sq, a.D, sQ,
                                      threadIdx.x, a.vec);
}

// dk and dv for one (batch * kv head, 64-row k tile, group of the kv head's
// query heads): k and v stay; the live (head, q tile) pairs of the group
// stream q, do, lse and delta through a 2-stage cp.async ring. Per q tile,
// warp (wr, wc) recomputes s^T and dp^T for keys 16 wr.. and q rows
// 32 wc.., writes p^T and ds^T = p^T (dp^T - delta) as bf16 to shared
// memory, and then accumulates dv += p^T do and dk += ds^T q (rows 16 wr..,
// columns wc D / 2..). With one group the block writes dk and dv; with
// more, it writes float32 partials that flash_bwd_reduce sums in order.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dkdv_mma(Args a) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kT * LD;
  bf16* sQG = sV + kT * LD;             // stage s: q at 2 s, do at 2 s + 1
  bf16* sP = sQG + 4 * kT * LD;         // p^T, (k, q)
  bf16* sS = sP + kT * kLDS;            // ds^T, (k, q)
  float* sLD = reinterpret_cast<float*>(sS + kT * kLDS);  // lse, delta

  const int bhk = blockIdx.x;
  const int b = bhk / a.Hkv, hk = bhk - b * a.Hkv;
  const int k0 = blockIdx.y * kT, k1 = min(k0 + kT, a.Sk);
  const int G = a.Hq / a.Hkv;
  const int h_lo = hk * G + blockIdx.z * G / a.nsplit;
  const int h_hi = hk * G + (blockIdx.z + 1) * G / a.nsplit;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const float sl2 = a.scale * kLog2e;

  const bf16* k = static_cast<const bf16*>(a.k) + b * a.st[K][0] +
                  hk * a.st[K][1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.st[V][0] +
                  hk * a.st[V][1];
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.st[Q][0];
  const bf16* gq = static_cast<const bf16*>(a.dout) + b * a.st[DO][0];

  int lo, hi;
  live_range(a, true, a.Sq, k0, k1, lo, hi);
  const int nql = hi - lo, total = (h_hi - h_lo) * nql;
  auto load_q = [&](int it, int s) {
    const int h = h_lo + it / nql, q0 = (lo + it % nql) * kT;
    bf16* d = sQG + 2 * s * kT * LD;
    mma::stage<kT, DP, LD, kMmaThreads>(d, q + h * a.st[Q][1], a.st[Q][2],
                                        q0, a.Sq, a.D, a.vec, threadIdx.x);
    mma::stage<kT, DP, LD, kMmaThreads>(d + kT * LD, gq + h * a.st[DO][1],
                                        a.st[DO][2], q0, a.Sq, a.D, a.vec,
                                        threadIdx.x);
    if (threadIdx.x < 2 * kT) {
      const int i = threadIdx.x & (kT - 1);
      const float* src = (threadIdx.x < kT ? a.lse : a.delta) +
                         ((long long)b * a.Hq + h) * a.Sq;
      const bool in = q0 + i < a.Sq;
      mma::cp4(mma::smem_u32(sLD + 2 * kT * s + threadIdx.x),
               in ? src + q0 + i : src, in ? 4 : 0);
    }
  };
  mma::stage<kT, DP, LD, kMmaThreads>(sK, k, a.st[K][2], k0, a.Sk, a.D,
                                      a.vec, threadIdx.x);
  mma::stage<kT, DP, LD, kMmaThreads>(sV, v, a.st[V][2], k0, a.Sk, a.D,
                                      a.vec, threadIdx.x);
  if (total > 0) load_q(0, 0);
  mma::cp_commit();

  float dk[DP / 16][4], dv[DP / 16][4];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int s = it & 1, q0 = (lo + it % nql) * kT;
    const bf16* cQ = sQG + 2 * s * kT * LD;
    const bf16* cG = cQ + kT * LD;
    const float* cL = sLD + 2 * kT * s;
    const float* cD = cL + kT;
    if (it + 1 < total) load_q(it + 1, s ^ 1);
    mma::cp_commit();
    mma::cp_wait<1>();                  // this stage has landed
    __syncthreads();

    float x[4][4], y[4][4];             // s^T and dp^T, then p^T and ds^T
    two_products<DP, LD>(x, y, sK, cQ, sV, cG, 16 * wr, 32 * wc, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 16 * wr + g + 8 * (e >> 1);
        const int ql = 32 * wc + 8 * j + 2 * t + (e & 1);
        const int qp = q0 + ql;
        float p = 0.f, ds = 0.f;
        if (kp < a.Sk && qp < a.Sq) {
          const float xs = kept(a, qp, kp) ? x[j][e] * sl2 : kMasked;
          p = exp2f(xs - cL[ql] * kLog2e);
          ds = p * (y[j][e] - cD[ql]);
        }
        x[j][e] = p;
        y[j][e] = ds;
      }
    put16x32(sP, kLDS, 16 * wr, 32 * wc, x, lane);
    put16x32(sS, kLDS, 16 * wr, 32 * wc, y, lane);
    __syncthreads();                    // p^T and ds^T complete
    acc_product<DP, LD>(dv, sP, cG, 16 * wr, wc * (DP / 2), lane);
    acc_product<DP, LD>(dk, sS, cQ, 16 * wr, wc * (DP / 2), lane);
    __syncthreads();                    // this stage, p^T and ds^T consumed
  }
  mma::cp_wait<0>();
  __syncthreads();

  if (a.nsplit == 1) {
    put_acc<DP>(sK, LD, 16 * wr, wc * (DP / 2), dk, a.scale, lane);
    put_acc<DP>(sV, LD, 16 * wr, wc * (DP / 2), dv, 1.f, lane);
    __syncthreads();
    bf16* dkp = static_cast<bf16*>(a.dk) + b * a.st[DK][0] +
                hk * a.st[DK][1];
    bf16* dvp = static_cast<bf16*>(a.dv) + b * a.st[DV][0] +
                hk * a.st[DV][1];
    mma::store<kT, DP, LD, kMmaThreads>(dkp, a.st[DK][2], k0, a.Sk, a.D, sK,
                                        threadIdx.x, a.vec);
    mma::store<kT, DP, LD, kMmaThreads>(dvp, a.st[DV][2], k0, a.Sk, a.D, sV,
                                        threadIdx.x, a.vec);
    return;
  }
  // partials [split][dk, dv][batch * kv head][Sk][DP], float32
  const size_t plane = (size_t)gridDim.x * a.Sk * DP;
  float* pk = a.part + 2 * blockIdx.z * plane + (size_t)bhk * a.Sk * DP;
  float* pv = pk + plane;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = k0 + 16 * wr + g + 8 * r;
      if (kp >= a.Sk) continue;
      const size_t off = (size_t)kp * DP + wc * (DP / 2) + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(pk + off) =
          make_float2(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<float2*>(pv + off) =
          make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
}

// dk = scale * sum_s dk_s and dv = sum_s dv_s over the nsplit partials, in
// split order, rounded once to bf16
__global__ void __launch_bounds__(kThreads)
    flash_bwd_reduce(Args a, int BHkv, int DP) {
  const long long n = (long long)BHkv * a.Sk * a.D;
  const size_t plane = (size_t)BHkv * a.Sk * DP;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int d = (int)(i % a.D);
    const long long rr = i / a.D;
    const int row = (int)(rr % a.Sk);
    const int bhk = (int)(rr / a.Sk);
    const size_t off = ((size_t)bhk * a.Sk + row) * DP + d;
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < a.nsplit; ++s) {
      sk += a.part[2 * s * plane + off];
      sv += a.part[(2 * s + 1) * plane + off];
    }
    const int b = bhk / a.Hkv, hk = bhk - b * a.Hkv;
    static_cast<bf16*>(a.dk)[b * a.st[DK][0] + hk * a.st[DK][1] +
                             (long long)row * a.st[DK][2] + d] =
        __float2bfloat16_rn(sk * a.scale);
    static_cast<bf16*>(a.dv)[b * a.st[DV][0] + hk * a.st[DV][1] +
                             (long long)row * a.st[DV][2] + d] =
        __float2bfloat16_rn(sv);
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

template <int DP>
constexpr int smem_dq_mma() {
  return (6 * kT * (DP + 8) + kT * kLDS) * (int)sizeof(bf16);
}

template <int DP>
constexpr int smem_dkdv_mma() {
  return (6 * kT * (DP + 8) + 2 * kT * kLDS) * (int)sizeof(bf16) +
         4 * kT * (int)sizeof(float);
}

unsigned delta_blocks(const Args& a, int B) {
  const long long rows = (long long)B * a.Hq * a.Sq;
  return (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
}

template <int DPT>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  constexpr int sq = smem_dq<DPT>(), sk = smem_dkdv<DPT>();
  cudaError_t err = launch_cache::allow_smem(flash_bwd_dq<DPT>, sq);
  if (err == cudaSuccess)
    err = launch_cache::allow_smem(flash_bwd_dkdv<DPT>, sk);
  if (err != cudaSuccess) return err;
  flash_bwd_delta<float><<<delta_blocks(a, B), kThreads, 0, st>>>(a, B);
  const dim3 gq((unsigned)(B * a.Hq), (unsigned)((a.Sq + kBQ - 1) / kBQ));
  flash_bwd_dq<DPT><<<gq, kThreads, sq, st>>>(a);
  const dim3 gk((unsigned)(B * a.Hkv), (unsigned)((a.Sk + kBKk - 1) / kBKk));
  flash_bwd_dkdv<DPT><<<gk, kThreads, sk, st>>>(a);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_mma(const Args& a, int B, cudaStream_t st) {
  constexpr int sq = smem_dq_mma<DP>(), sk = smem_dkdv_mma<DP>();
  cudaError_t err = launch_cache::allow_smem(flash_bwd_dq_mma<DP>, sq);
  if (err == cudaSuccess)
    err = launch_cache::allow_smem(flash_bwd_dkdv_mma<DP>, sk);
  if (err != cudaSuccess) return err;
  flash_bwd_delta<bf16><<<delta_blocks(a, B), kThreads, 0, st>>>(a, B);
  const dim3 gq((unsigned)(B * a.Hq), (unsigned)((a.Sq + kT - 1) / kT));
  flash_bwd_dq_mma<DP><<<gq, kMmaThreads, sq, st>>>(a);
  const dim3 gk((unsigned)(B * a.Hkv), (unsigned)((a.Sk + kT - 1) / kT),
                (unsigned)a.nsplit);
  flash_bwd_dkdv_mma<DP><<<gk, kMmaThreads, sk, st>>>(a);
  if (a.nsplit > 1) {
    const long long n = (long long)B * a.Hkv * a.Sk * a.D;
    const long long want = (n + kThreads - 1) / kThreads;
    const unsigned blocks = (unsigned)(want < (1 << 16) ? want : 1 << 16);
    flash_bwd_reduce<<<blocks, kThreads, 0, st>>>(a, B * a.Hkv, DP);
  }
  return cudaSuccess;
}

cudaError_t dispatch_f32(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 16) return launch<1>(a, B, st);
  if (a.D <= 32) return launch<2>(a, B, st);
  if (a.D <= 64) return launch<4>(a, B, st);
  if (a.D <= 128) return launch<8>(a, B, st);
  return launch<16>(a, B, st);
}

// the bf16 kernels' padded head dim
int dp_of(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }

cudaError_t dispatch_bf16(const Args& a, int B, cudaStream_t st) {
  switch (dp_of(a.D)) {
    case 32: return launch_mma<32>(a, B, st);
    case 64: return launch_mma<64>(a, B, st);
    case 128: return launch_mma<128>(a, B, st);
    default: return launch_mma<256>(a, B, st);
  }
}

// How many groups the G query heads of a kv head are split into for dk/dv:
// enough that the grid holds a block for every SM of the current device
// (B * Hkv * ceil(Sk / 64) blocks a group), at most G.
int nsplit_for(int B, int Hq, int Hkv, int Sk) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long base = (long long)B * Hkv * ((Sk + kT - 1) / kT);
  if (base >= sms) return 1;
  const long long n = (sms + base - 1) / base;
  return n < Hq / Hkv ? (int)n : Hq / Hkv;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// The bytes of float32 scratch that flash_attention_bwd needs as ptrs[10]
// for these shapes (0: none; the bf16 dk/dv kernel then writes dk and dv
// itself).
long long flash_attention_bwd_scratch(int B, int Hq, int Hkv, int Sk, int D,
                                      int dtype) {
  if (dtype != 1 || B <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      D < 1 || D > 256)
    return 0;
  const int ns = nsplit_for(B, Hq, Hkv, Sk);
  return ns > 1 ? 2LL * ns * B * Hkv * Sk * dp_of(D) * (long long)sizeof(float)
                : 0;
}

// ptrs: q, k, v, o, do, lse, delta, dq, dk, dv on the current device, and
// the scratch of flash_attention_bwd_scratch's size (null when that is 0);
// strides: 8 x 3 element strides (batch, head, sequence) of q, k, v, o, do,
// dq, dk, dv, the last dimension of each contiguous. q, k, v, o, do, dq, dk,
// dv share one dtype (0 = float32, 1 = bfloat16); lse (B, Hq, Sq) float32
// is the forward's, delta (B, Hq, Sq) float32 is scratch. 1 <= D <= 256,
// Hq a multiple of Hkv, B * Hq < 2^31, Sq < 2^21, Sk < 2^20. Launches the
// kernels on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises.
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
         causal, window, scale, nullptr, 1, 0};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_f32(a, B, st);
  } else if (dtype == 1) {
    a.nsplit = nsplit_for(B, Hq, Hkv, Sk);
    a.part = static_cast<float*>(ptrs[10]);
    if (a.nsplit > 1 && a.part == nullptr) return (int)cudaErrorInvalidValue;
    // 16-byte copies need 16-byte aligned rows: every base and stride
    bool vec = true;
    for (int i = 0; i < 10; ++i)        // all but lse and delta
      vec = vec && (i == 5 || i == 6 || aligned16(ptrs[i]));
    for (int i = 0; i < 24; ++i) vec = vec && strides[i] % 8 == 0;
    a.vec = vec ? 1 : 0;
    err = dispatch_bf16(a, B, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
