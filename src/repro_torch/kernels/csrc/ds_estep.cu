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
// here each thread gathers directly. Three routes, chosen by the caller
// (kernels/ds_estep.py::estep_route, from the shape alone):
//
//  * task (C <= 8, V <= 32): one task per thread, its C class sums in
//    registers, each vote's row read as one vector (8 bytes at C = 2, 16
//    at C = 4, 2 x 16 at C = 8; scalars where C*4 is not a multiple of 8),
//    logp and post stored as vectors, so a warp writes one contiguous run
//    of 32*C*4 bytes per output. Its placement follows the shape:
//      - warp mode (R*C <= 1024, T <= 256, T*V <= 2048: the stream
//        refresh's many small tables): one warp per batch element, which
//        copies its table and its idx block into its own slice of shared
//        memory with one wave of cp.async, then scores its tasks;
//      - block mode: a persistent grid of at most two 512-thread blocks an
//        SM, each serving one batch element. A block copies the row table
//        into shared memory once (16-byte cp.async where aligned; tables
//        up to 96 KB, e.g. W=1024, C=4: 65.6 KB), then walks tiles of 512
//        tasks whose idx blocks (512*V int32, contiguous) stream through a
//        ring of up to 4 shared-memory stages by cp.async, so the next
//        tiles' loads are in flight while one is scored (element copies
//        where idx's base is not aligned). A larger table (W=1024, C=8:
//        262 KB) keeps its first rows in shared memory, as many as 176 KB
//        hold, one block an SM, and reads the rest from L2 with 16-byte
//        ld.global.nc (on an H100 this beat both the whole table in L2 and
//        a 2-block cluster sharing its halves through distributed shared
//        memory; PERF.md);
//  * group (other C <= 32): a group of G = next_pow2(C) lanes holds one
//    task and the softmax reduces across the group by warp shuffles;
//  * wide (C > 32): the whole block holds one task and reduces through
//    shared memory.
// The group and wide kernels stage a table of up to kSmemBudget bytes in
// shared memory and otherwise gather with __ldg from L2.
//
// Numerics, every route: the vote sum runs in the plain version's order
// (v = 0, 1, ... from 0, then - log C, each add rounded on its own), so
// logp matches it bit for bit; indices outside [0, R) are skipped (read as
// the null row) instead of faulting. The task route's softmax takes a
// sequential max m, e_c = expf(acc_c - m), s = sum_c e_c in class order and
// post = e_c / s, so runs repeat bit for bit and a zero-vote task comes out
// exactly 1/C. No atomics.
//
// Launch facts (SM count, occupancy, the shared-memory opt-in) are queried
// once per device and kernel (launch_cache.cuh), not per call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_cache.cuh"

namespace {

constexpr int kThreads = 256;              // group and wide kernels
constexpr int kSmemBudget = 96 * 1024;     // a staged table, at most
constexpr int kSmemMax = 227 * 1024;       // an H100 block's opt-in
constexpr unsigned kFull = 0xffffffffu;

// the task route
constexpr int kTaskMaxC = 8;
constexpr int kTaskMaxV = 32;
constexpr int kTaskThreads = 512;          // block mode: a tile of 512 tasks
constexpr int kTaskStages = 4;             // the idx ring's depth, at most
constexpr int kTaskBlocksPerSm = 2;
constexpr int kPartBudget = 176 * 1024;    // L2 mode: rows staged
constexpr int kWarpTable = 1024;           // warp mode: table floats
constexpr int kWarpIdx = 2048;             // warp mode: idx ints
constexpr int kWarpMaxT = 256;             // warp mode: tasks
constexpr int kWarpsPerBlock = 4;

// route codes of ds_estep_f32 (kernels/ds_estep.py::ROUTES)
enum Route { kRouteTask = 0, kRouteGroup = 1, kRouteWide = 2 };
// the task route's placements (ds_estep_task_plan)
enum Mode { kModeWarp = 0, kModeSmem = 1, kModeL2 = 2 };

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

// ---- the task route ------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0..3) committed groups of this thread are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// n 4-byte words from global src to 16-byte aligned shared dst, threads
// tid, tid + nthr, ... each issuing cp.async copies: 16 bytes where src is
// 16-byte aligned, 8 where it is 8-byte aligned, then single words.
__device__ __forceinline__ void copy_words(void* dst, const void* src, int n,
                                           int tid, int nthr) {
  float* d = static_cast<float*>(dst);
  const float* s = static_cast<const float*>(src);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  int done = 0;
  if ((a & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nthr) cp_async<16>(d + 4 * i, s + 4 * i);
    done = n4 << 2;
  } else if ((a & 7) == 0) {
    const int n2 = n >> 1;
    for (int i = tid; i < n2; i += nthr) cp_async<8>(d + 2 * i, s + 2 * i);
    done = n2 << 1;
  }
  for (int i = done + tid; i < n; i += nthr) cp_async<4>(d + i, s + i);
}

// acc[c] += row[c] with vector reads from shared memory; row is aligned to
// its vector
template <int C>
__device__ __forceinline__ void add_row(float (&acc)[C], const float* row) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + k);
      acc[k] += v.x;
      acc[k + 1] += v.y;
      acc[k + 2] += v.z;
      acc[k + 3] += v.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 2) {
      const float2 v = *reinterpret_cast<const float2*>(row + k);
      acc[k] += v.x;
      acc[k + 1] += v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] += row[k];
  }
}

// the same from global memory (L2) through the read-only path; vector
// reads where the table is aligned to them (vec)
template <int C>
__device__ __forceinline__ void add_row_ldg(float (&acc)[C],
                                            const float* row, bool vec) {
  if constexpr (C % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < C; k += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + k));
        acc[k] += v.x;
        acc[k + 1] += v.y;
        acc[k + 2] += v.z;
        acc[k + 3] += v.w;
      }
      return;
    }
  } else if constexpr (C % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < C; k += 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(row + k));
        acc[k] += v.x;
        acc[k + 1] += v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] += __ldg(row + k);
}

template <int C>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 4)
      *reinterpret_cast<float4*>(dst + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int k = 0; k < C; k += 2)
      *reinterpret_cast<float2*>(dst + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) dst[k] = v[k];
  }
}

// Where a task's rows live: in this block's shared memory (kModeSmem and
// warp mode: tab0), or rows [0, split) there and the rest in L2 (kModeL2:
// tab1 is the table in global memory).
struct Tab {
  const float* tab0;
  const float* tab1;
  int split;
  bool vec;
};

// acc += rows[iv[v]] for v = 0, 1, ..., V - 1 in turn. The indices come
// eight at a time from shared memory, so their row reads can all be in
// flight before the adds, which keep the order of v.
template <int C, int kMode>
__device__ __forceinline__ void sum_votes(float (&acc)[C], const int* iv,
                                          int V, int R, const Tab& tab) {
  for (int v0 = 0; v0 < V; v0 += 8) {
    int r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = v0 + k < V ? iv[v0 + k] : -1;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if ((unsigned)r[k] < (unsigned)R) {
        if constexpr (kMode == kModeL2) {
          if (r[k] < tab.split)
            add_row<C>(acc, tab.tab0 + r[k] * C);
          else
            add_row_ldg<C>(acc, tab.tab1 + (size_t)r[k] * C, tab.vec);
        } else {
          add_row<C>(acc, tab.tab0 + r[k] * C);
        }
      }
    }
  }
}

// acc -= log C (logp), then e = softmax(acc) in a fixed order: a
// sequential max m, e_c = expf(acc_c - m), s = e_0 + e_1 + ... in class
// order, e_c / s
template <int C>
__device__ __forceinline__ void softmax_task(float (&acc)[C], float log_c,
                                             float (&e)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] -= log_c;
  float m = acc[0];
#pragma unroll
  for (int c = 1; c < C; ++c) m = fmaxf(m, acc[c]);
#pragma unroll
  for (int c = 0; c < C; ++c) e[c] = expf(acc[c] - m);
  float s = e[0];
#pragma unroll
  for (int c = 1; c < C; ++c) s += e[c];
#pragma unroll
  for (int c = 0; c < C; ++c) e[c] = e[c] / s;
}

// logp and post of one task, stored as vectors
template <int C>
__device__ __forceinline__ void finish_task(float (&acc)[C], float log_c,
                                            float* lp, float* pp) {
  float e[C];
  softmax_task<C>(acc, log_c, e);
  store_row<C>(lp, acc);
  store_row<C>(pp, e);
}

// Warp mode: warp w of block k serves batch element k * kWarpsPerBlock + w.
// Its slice of shared memory holds the table (`held` floats, a multiple of
// 4) and then its T x V idx block; both arrive by one wave of cp.async.
template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ds_estep_task_warp(const float* __restrict__ rows,
                   const int* __restrict__ idx, float* __restrict__ logp,
                   float* __restrict__ post, int B, int R, int T, int V,
                   int held, int slice, float log_c) {
  extern __shared__ __align__(16) float task_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;                     // the whole warp: no block sync
  float* tab = task_smem + warp * slice;
  int* iv = reinterpret_cast<int*>(tab + held);
  copy_words(tab, rows + (size_t)b * R * C, R * C, lane, 32);
  copy_words(iv, idx + (size_t)b * T * V, T * V, lane, 32);
  cp_commit();
  cp_wait(0);
  __syncwarp();
  float* logp_b = logp + (size_t)b * T * C;
  float* post_b = post + (size_t)b * T * C;
  const Tab t_{tab, nullptr, R, true};
  for (int t = lane; t < T; t += 32) {
    float acc[C] = {};
    sum_votes<C, kModeSmem>(acc, iv + t * V, V, R, t_);
    finish_task<C>(acc, log_c, logp_b + (size_t)t * C, post_b + (size_t)t * C);
  }
}

// Block mode: block k serves batch element k / bpb and walks its tiles
// k % bpb, k % bpb + bpb, ... of kTaskThreads tasks. Shared memory holds
// the table (kModeSmem) or its first `split` rows (kModeL2), `held` floats
// (a multiple of 4), then a ring of `stages` (1..4) tiles of idx.
template <int C, int kMode>
__global__ void __launch_bounds__(kTaskThreads, kTaskBlocksPerSm)
ds_estep_task(const float* __restrict__ rows, const int* __restrict__ idx,
              float* __restrict__ logp, float* __restrict__ post, int bpb,
              int R, int T, int V, int split, int held, int stages,
              float log_c) {
  extern __shared__ __align__(16) float task_smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / bpb, bx = blockIdx.x % bpb;
  const float* rows_b = rows + (size_t)b * R * C;
  const int* idx_b = idx + (size_t)b * T * V;
  float* logp_b = logp + (size_t)b * T * C;
  float* post_b = post + (size_t)b * T * C;
  int* ring = reinterpret_cast<int*>(task_smem + held);
  const int tile = kTaskThreads * V;
  const int n_tiles = (T + kTaskThreads - 1) / kTaskThreads;
  const int mine = bx < n_tiles ? (n_tiles - 1 - bx) / bpb + 1 : 0;
  constexpr int kVecMask = C % 4 == 0 ? 15 : 7;
  Tab tab{task_smem, rows_b, split,
          (reinterpret_cast<uintptr_t>(rows_b) & kVecMask) == 0};
  copy_words(task_smem, rows_b, split * C, tid, kTaskThreads);
  cp_commit();                            // the table: the oldest group
  auto issue = [&](int j) {               // my j-th tile into its stage
    const int t0 = (bx + j * bpb) * kTaskThreads;
    const int n = (T - t0 < kTaskThreads ? T - t0 : kTaskThreads) * V;
    copy_words(ring + (j % stages) * tile, idx_b + (size_t)t0 * V, n, tid,
               kTaskThreads);
  };
  for (int j = 0; j < stages - 1; ++j) {
    if (j < mine) issue(j);
    cp_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + stages - 1 < mine) issue(i + stages - 1);
    cp_commit();
    cp_wait(stages - 1);                  // tile i (and the table) landed
    __syncthreads();
    const int t = (bx + i * bpb) * kTaskThreads + tid;
    if (t < T) {
      float acc[C] = {};
      sum_votes<C, kMode>(acc, ring + (i % stages) * tile + tid * V, V, R,
                          tab);
      finish_task<C>(acc, log_c, logp_b + (size_t)t * C,
                     post_b + (size_t)t * C);
    }
    __syncthreads();                      // stage i % stages is free again
  }
  cp_wait(0);
}

// ---- host side -------------------------------------------------------------

constexpr int round4(long long n) { return (int)((n + 3) / 4 * 4); }

struct Plan {
  int mode;     // Mode, or -1 where the route cannot take the shape
  int split;    // rows staged in shared memory
  int held;     // floats of table a block (warp mode: a warp) holds
  int stages;   // block mode: the idx ring's depth
  int smem;     // dynamic shared memory of a block, bytes
};

// The task route's placement for a shape: a function of (B, R, C, T, V)
// alone, never of the device.
Plan task_plan(int B, int R, int C, int T, int V) {
  Plan p{-1, 0, 0, 0, 0};
  if (C < 1 || C > kTaskMaxC || V < 0 || V > kTaskMaxV || R < 1) return p;
  const long long table = (long long)R * C;
  if (table <= kWarpTable && T <= kWarpMaxT &&
      (long long)T * V <= kWarpIdx) {
    p.mode = kModeWarp;
    p.split = R;
    p.held = round4(table);
    p.smem = kWarpsPerBlock * 4 * (p.held + round4((long long)T * V));
    p.stages = 1;
    return p;
  }
  const int tile = 4 * kTaskThreads * (V > 0 ? V : 1);
  if (table * 4 <= kSmemBudget) {
    p.mode = kModeSmem;
    p.split = R;
  } else {                                // as many rows as fit, then L2
    int budget = kSmemMax - 2 * tile;
    if (budget > kPartBudget) budget = kPartBudget;
    const int fit = budget / (4 * C);
    p.mode = kModeL2;
    p.split = R < fit ? R : fit;
  }
  p.held = round4((long long)p.split * C);
  const int stages = (kSmemMax - 4 * p.held) / tile;
  p.stages = stages < kTaskStages ? stages : kTaskStages;
  if (p.stages < 1) {
    p.mode = -1;
    return p;
  }
  p.smem = 4 * p.held + p.stages * tile;
  return p;
}

template <int C>
cudaError_t launch_task(const Plan& p, const float* rows, const int* idx,
                        float* logp, float* post, int B, int R, int T, int V,
                        float log_c, int dev, const launch_cache::Device& d,
                        cudaStream_t st) {
  if (p.mode == kModeWarp) {
    const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    ds_estep_task_warp<C><<<grid, kWarpsPerBlock * 32, p.smem, st>>>(
        rows, idx, logp, post, B, R, T, V, p.held,
        p.smem / (4 * kWarpsPerBlock), log_c);
    return cudaSuccess;
  }
  auto kernel = p.mode == kModeSmem ? ds_estep_task<C, kModeSmem>
                                    : ds_estep_task<C, kModeL2>;
  int per_sm = 1;
  cudaError_t err = launch_cache::blocks_per_sm(kernel, dev, d, kTaskThreads,
                                                p.smem, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm > kTaskBlocksPerSm) per_sm = kTaskBlocksPerSm;
  if (per_sm < 1) per_sm = 1;
  const long long wave = (long long)per_sm * d.sms;
  const int n_tiles = (T + kTaskThreads - 1) / kTaskThreads;
  long long bpb = (wave + B - 1) / B;
  if (bpb > n_tiles) bpb = n_tiles;
  if (bpb < 1) bpb = 1;
  if (bpb * B > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)(bpb * B), kTaskThreads, p.smem, st>>>(
      rows, idx, logp, post, (int)bpb, R, T, V, p.split, p.held, p.stages,
      log_c);
  return cudaSuccess;
}

// Blocks per batch element for the group and wide kernels: one wave of
// resident blocks over the card, split across the B batch elements, and
// never more than the tiles.
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int smem, int B, int tiles, int dev,
                        const launch_cache::Device& d, int* bpb) {
  int per_sm = 0;
  cudaError_t err =
      launch_cache::blocks_per_sm(kernel, dev, d, kThreads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int wave = per_sm * d.sms;
  int n = (wave + B - 1) / B;
  if (n > tiles) n = tiles;
  *bpb = n < 1 ? 1 : n;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int ds_estep_smem_budget() { return kSmemBudget; }

// The task route's placement for a shape: out[0] the mode (0 one warp per
// batch element, 1 the table in a block's shared memory, 2 its first out[1]
// rows there and the rest in L2), out[2] the idx ring's stages, out[3] a
// block's dynamic shared memory in bytes. Returns 0, or -1 where the route
// cannot take the shape.
int ds_estep_task_plan(int B, int R, int C, int T, int V, int* out) {
  const Plan p = task_plan(B, R, C, T, V);
  out[0] = p.mode;
  out[1] = p.split;
  out[2] = p.stages;
  out[3] = p.smem;
  return p.mode < 0 ? -1 : 0;
}

// rows (B, R, C) f32, idx (B, T, V) i32, logp/post (B, T, C) f32, all
// contiguous on the current device; log_c is log C rounded to float, as the
// plain version subtracts it; route: 0 task, 1 group, 2 wide.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue where the route cannot take the shape; it never
// synchronises.
int ds_estep_f32(const float* rows, const int* idx, float* logp, float* post,
                 int B, int R, int C, int T, int V, float log_c, int route,
                 void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  launch_cache::Device d{};
  cudaError_t err = launch_cache::device(&dev, &d);
  if (err != cudaSuccess) return (int)err;
  if (route == kRouteTask) {
    const Plan p = task_plan(B, R, C, T, V);
    if (p.mode < 0) return (int)cudaErrorInvalidValue;
    switch (C) {
#define DS_TASK_CASE(K)                                                      \
  case K:                                                                    \
    err = launch_task<K>(p, rows, idx, logp, post, B, R, T, V, log_c, dev,   \
                         d, st);                                             \
    break;
      DS_TASK_CASE(1) DS_TASK_CASE(2) DS_TASK_CASE(3) DS_TASK_CASE(4)
      DS_TASK_CASE(5) DS_TASK_CASE(6) DS_TASK_CASE(7) DS_TASK_CASE(8)
#undef DS_TASK_CASE
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const long long table = (long long)R * C * sizeof(float);
  const bool staged = table <= kSmemBudget;
  const int smem = staged ? (int)table : 0;
  int bpb = 1;
  if (route == kRouteGroup) {
    if (C > 32) return (int)cudaErrorInvalidValue;
    int G = 1;
    while (G < C) G <<= 1;
    const int per_tile = kThreads / G;
    const int tiles = (T + per_tile - 1) / per_tile;
    auto kernel = staged ? ds_estep_group<true> : ds_estep_group<false>;
    err = wave_blocks(kernel, smem, B, tiles, dev, d, &bpb);
    if (err == cudaSuccess)
      kernel<<<B * bpb, kThreads, smem, st>>>(rows, idx, logp, post, bpb, R,
                                              C, T, V, G, log_c);
  } else if (route == kRouteWide) {
    auto kernel = staged ? ds_estep_wide<true> : ds_estep_wide<false>;
    err = wave_blocks(kernel, smem, B, T, dev, d, &bpb);
    if (err == cudaSuccess)
      kernel<<<B * bpb, kThreads, smem, st>>>(rows, idx, logp, post, bpb, R,
                                              C, T, V, log_c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
