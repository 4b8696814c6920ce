// Fused Dawid-Skene E-step for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ds_estep.py::ds_estep
// (body _ds_estep_kernel). For each batch element b and task t:
//
//   logp[b, t, c] = sum_v rows[b, idx[b, t, v], c] - log C
//   post[b, t, :] = softmax(logp[b, t, :])
//
// rows is the (R, C) log-confusion row table of the EM (row w*C + l holds
// log P(vote = l | true = c) for worker w) with an all-zero null row R-1 that
// padded votes point at, so no mask is needed and a zero-vote task comes out
// exactly uniform.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel moves
//   bytes = B*T*V*4 (idx) + B*R*C*4 (rows) + 2*B*T*C*4 (logp, post)
// and does B*T*(V + 3)*C flops, far below the 67 TFLOP/s float32 rate, so
// it is bound by memory:
//   offline EM (B=1, T=2^20, V=5, W=1024, C=4): ~54.6 MB -> ~16 us;
//   stream refresh (B=512, T=32, V=5, R=19, C=2): ~0.67 MB -> ~0.2 us,
//   far below the launch overhead, so that shape is launch-bound.
//
// Design for this card rather than the TPU block: the TPU kernel gathers
// rows with a one-hot MXU matmul because it has no fast vector gather;
// here each thread gathers directly. Threads map to (task, class) pairs:
// for C <= 32 a group of G = next_pow2(C) lanes holds one task and the
// softmax reduces across the group by warp shuffles; for C > 32 the whole
// block holds one task and reduces through shared memory. A block stages
// its batch element's row table in dynamic shared memory when R*C*4 bytes
// fit kSmemBudget (e.g. W=1024, C=4: 65.6 KB), and otherwise gathers with
// __ldg from global memory, where the table stays L2-resident (W=1024,
// C=8: 262 KB). The grid is one wave of resident blocks (occupancy API),
// each looping over task tiles, so a staged table is read once per block
// and no second, partial wave is left at the tail. The vote sum runs in
// the plain version's order (sum over v, then subtract log C), so logp
// matches it bit for bit; indices outside [0, R) are skipped (read as the
// null row) instead of faulting.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;
constexpr unsigned kFull = 0xffffffffu;

template <bool kStaged>
__device__ __forceinline__ float row_at(const float* tab, int off) {
  if constexpr (kStaged) {
    return tab[off];
  } else {
    return __ldg(tab + off);
  }
}

template <bool kStaged>
__device__ __forceinline__ const float* stage_rows(const float* rows_b,
                                                   int n, float* smem) {
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = rows_b[i];
    __syncthreads();
    return smem;
  } else {
    return rows_b;
  }
}

// C <= 32: G lanes per task, kThreads / G tasks per tile.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
ds_estep_group(const float* __restrict__ rows, const int* __restrict__ idx,
               float* __restrict__ logp, float* __restrict__ post,
               int blocks_per_b, int R, int C, int T, int V, int G,
               float log_c) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / blocks_per_b;
  const int bx = blockIdx.x % blocks_per_b;
  const float* tab = stage_rows<kStaged>(rows + (size_t)b * R * C, R * C,
                                         smem);
  const int* idx_b = idx + (size_t)b * T * V;
  float* logp_b = logp + (size_t)b * T * C;
  float* post_b = post + (size_t)b * T * C;
  const int c = threadIdx.x % G;
  const int tl = threadIdx.x / G;
  const int per_tile = kThreads / G;
  // t0 depends on the block only, so every lane of a warp runs the same
  // number of iterations and the full-mask shuffles below are safe
  for (int t0 = bx * per_tile; t0 < T; t0 += blocks_per_b * per_tile) {
    const int t = t0 + tl;
    const bool live = c < C && t < T;
    float acc = 0.f;
    if (live) {
      for (int v = 0; v < V; ++v) {
        const int r = __ldg(idx_b + (size_t)t * V + v);
        if ((unsigned)r < (unsigned)R) acc += row_at<kStaged>(tab, r * C + c);
      }
      acc -= log_c;
    }
    float m = live ? acc : -INFINITY;
    for (int off = G >> 1; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off, G));
    const float e = live ? expf(acc - m) : 0.f;
    float s = e;
    for (int off = G >> 1; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off, G);
    if (live) {
      logp_b[(size_t)t * C + c] = acc;
      post_b[(size_t)t * C + c] = e / s;
    }
  }
}

// Block-wide max or sum; every thread of the block must call it.
__device__ float block_reduce(float v, bool is_max, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kThreads >> 5) ? red[lane] : (is_max ? -INFINITY : 0.f);
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, off);
      v = is_max ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// C > 32: one task per block iteration, classes strided over the block.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
ds_estep_wide(const float* __restrict__ rows, const int* __restrict__ idx,
              float* __restrict__ logp, float* __restrict__ post,
              int blocks_per_b, int R, int C, int T, int V, float log_c) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x / blocks_per_b;
  const int bx = blockIdx.x % blocks_per_b;
  const float* tab = stage_rows<kStaged>(rows + (size_t)b * R * C, R * C,
                                         smem);
  const int* idx_b = idx + (size_t)b * T * V;
  float* logp_b = logp + (size_t)b * T * C;
  float* post_b = post + (size_t)b * T * C;
  for (int t = bx; t < T; t += blocks_per_b) {
    const int* iv = idx_b + (size_t)t * V;
    float* lp = logp_b + (size_t)t * C;
    float* pp = post_b + (size_t)t * C;
    float m = -INFINITY;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.f;
      for (int v = 0; v < V; ++v) {
        const int r = __ldg(iv + v);
        if ((unsigned)r < (unsigned)R) acc += row_at<kStaged>(tab, r * C + c);
      }
      acc -= log_c;
      lp[c] = acc;               // read back below by the same thread only
      m = fmaxf(m, acc);
    }
    m = block_reduce(m, true, red);
    float s = 0.f;
    for (int c = threadIdx.x; c < C; c += kThreads) s += expf(lp[c] - m);
    s = block_reduce(s, false, red);
    for (int c = threadIdx.x; c < C; c += kThreads)
      pp[c] = expf(lp[c] - m) / s;
  }
}

// Blocks per batch element: one wave of resident blocks over the card,
// split across the B batch elements, and never more than the tiles.
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int smem, int B, int tiles,
                        int* bpb) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const int wave = per_sm * sms;
  int n = (wave + B - 1) / B;
  if (n > tiles) n = tiles;
  *bpb = n < 1 ? 1 : n;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int ds_estep_smem_budget() { return kSmemBudget; }

// rows (B, R, C) f32, idx (B, T, V) i32, logp/post (B, T, C) f32, all
// contiguous on the current device; log_c is log C rounded to float, as the
// plain version subtracts it. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
int ds_estep_f32(const float* rows, const int* idx, float* logp, float* post,
                 int B, int R, int C, int T, int V, float log_c,
                 void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long table = (long long)R * C * sizeof(float);
  const bool staged = table <= kSmemBudget;
  const int smem = staged ? (int)table : 0;
  cudaError_t err = cudaSuccess;
  int bpb = 1;
  if (C <= 32) {
    int G = 1;
    while (G < C) G <<= 1;
    const int per_tile = kThreads / G;
    const int tiles = (T + per_tile - 1) / per_tile;
    auto kernel = staged ? ds_estep_group<true> : ds_estep_group<false>;
    err = wave_blocks(kernel, smem, B, tiles, &bpb);
    if (err == cudaSuccess)
      kernel<<<B * bpb, kThreads, smem, st>>>(rows, idx, logp, post, bpb, R,
                                              C, T, V, G, log_c);
  } else {
    auto kernel = staged ? ds_estep_wide<true> : ds_estep_wide<false>;
    err = wave_blocks(kernel, smem, B, T, &bpb);
    if (err == cudaSuccess)
      kernel<<<B * bpb, kThreads, smem, st>>>(rows, idx, logp, post, bpb, R,
                                              C, T, V, log_c);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
