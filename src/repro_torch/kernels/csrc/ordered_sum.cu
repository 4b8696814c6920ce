// In-order float32 sums for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves these sums to XLA. They are
// the stream learner's products and row sums (learning/linear.py), which
// must round the same on the CPU and the card because their results decide
// integers. Before this kernel they ran as a product tensor and
// torch.segment_reduce(lengths=...), which on the card turns its 2-D
// lengths into offsets with an int64 scan once per product row: 73-81% of
// the stream cells' device time, for offsets that are arange * size.
//
// Two entry points, each output a sum started at 0 and added in index order,
// every product and every add rounded to float32 on its own:
//
//   ordered_matmul: out[b, i, j] = (((0 + a[b,i,0]*c[b,0,j])
//                                     + a[b,i,1]*c[b,1,j]) + ...)
//                   for a (batch, n, k) and c (batch, k, m), any strides;
//   segment_sum:    out[r, s, j] = (((0 + g[r, s*size, j])
//                                     + g[r, s*size + 1, j]) + ...)
//                   for g (R, S*size, C), any strides.
//
// That is what the product tensor plus segment_reduce computes, on the CPU
// and on the card, bit for bit. The adds and products are __fadd_rn and
// __fmul_rn: at -O3 nvcc would otherwise contract s + a*c into one fma,
// which rounds once where the plain version rounds twice.
//
// Bound on an H100 SXM (3.35 TB/s): a few float operations a loaded float,
// so bytes. Each input byte is read once and each output written once, at
// the stream's shapes (65536 shard rows, window 32, ring 256, F 8, C 2):
//   tick.fuse      (65536, 32, 8) @ (65536, 8, 2):   88 MB -> 26 us;
//   fit logits     (32768, 256, 8) @ (32768, 8, 2): 337 MB -> 100 us;
//   fit gradient   (32768, 8, 256) @ (32768, 256, 2), a transposed view:
//                                                    337 MB -> 100 us;
//   _row_sum level (32768, 256, 2) in 32s:           76 MB -> 23 us.
//
// Design: one thread per output row, holding MT = 4, 2 or 1 of its m outputs
// in registers (the largest that divides m; m = 2 in every stream cell), so
// a row of a is read once for MT outputs, element by element at a's strides.
// Rows are numbered batch-major, so the threads of a warp share a batch's
// k x m block of c, which the read-only cache broadcasts to them. Offsets
// are 64-bit: ranked admission's backlog product has 65536 x 1024 rows. The
// order of the adds is fixed, so results repeat bit for bit.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;

// v = q * d + r with 0 <= r < d, in 32 bits where v fits
__device__ __forceinline__ void split(long long v, int d, long long& q,
                                      int& r) {
  if (v <= 0xffffffffLL) {
    const unsigned u = (unsigned)v, qu = u / (unsigned)d;
    q = qu;
    r = (int)(u - qu * (unsigned)d);
  } else {
    q = v / d;
    r = (int)(v - q * d);
  }
}

template <int MT>
__device__ __forceinline__ void add_products(float (&acc)[MT], float x,
                                             const float* __restrict__ c,
                                             long long c_sm) {
#pragma unroll
  for (int q = 0; q < MT; ++q)
    acc[q] = __fadd_rn(acc[q], __fmul_rn(x, __ldg(c + q * c_sm)));
}

// One thread per (row, chunk of MT outputs); rows = batch * n.
template <int MT>
__global__ void __launch_bounds__(kThreads)
ordered_matmul_rows(const float* __restrict__ a, long long a_sb,
                    long long a_sn, long long a_sk,
                    const float* __restrict__ c, long long c_sb,
                    long long c_sk, long long c_sm, float* __restrict__ out,
                    long long rows, int n, int k, int m, int chunks) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= rows * chunks) return;
  long long row, b;
  int chunk, i;
  split(idx, chunks, row, chunk);
  split(row, n, b, i);
  const int j0 = chunk * MT;
  const float* ap = a + b * a_sb + i * a_sn;
  const float* cp = c + b * c_sb + j0 * c_sm;
  float acc[MT];
#pragma unroll
  for (int q = 0; q < MT; ++q) acc[q] = 0.f;
#pragma unroll 8
  for (int t = 0; t < k; ++t)
    add_products(acc, __ldg(ap + t * a_sk), cp + t * c_sk, c_sm);
  float* o = out + row * m + j0;
#pragma unroll
  for (int q = 0; q < MT; ++q) o[q] = acc[q];
}

// One thread per (segment row, chunk of MT columns); rows = R * S.
template <int MT>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows(const float* __restrict__ g, long long g_sr, long long g_sn,
                 long long g_sc, float* __restrict__ out, long long rows,
                 int S, int size, int C, int chunks) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= rows * chunks) return;
  long long row, r;
  int chunk, s;
  split(idx, chunks, row, chunk);
  split(row, S, r, s);
  const int j0 = chunk * MT;
  const float* gp = g + r * g_sr + (long long)s * size * g_sn + j0 * g_sc;
  float acc[MT];
#pragma unroll
  for (int q = 0; q < MT; ++q) acc[q] = 0.f;
#pragma unroll 8
  for (int t = 0; t < size; ++t) {
    const float* gt = gp + t * g_sn;
#pragma unroll
    for (int q = 0; q < MT; ++q) acc[q] = __fadd_rn(acc[q], __ldg(gt + q * g_sc));
  }
  float* o = out + row * C + j0;
#pragma unroll
  for (int q = 0; q < MT; ++q) o[q] = acc[q];
}

// outputs a thread: the largest of 4, 2, 1 that divides m
int outputs_per_thread(int m) { return m % 4 == 0 ? 4 : m % 2 == 0 ? 2 : 1; }

bool grid_of(long long rows, int chunks, unsigned* blocks) {
  if (rows > LLONG_MAX / chunks) return false;
  const long long n = (rows * chunks + kThreads - 1) / kThreads;
  if (n > INT_MAX) return false;
  *blocks = (unsigned)n;
  return true;
}

template <int MT>
void launch_matmul(const float* a, long long a_sb, long long a_sn,
                   long long a_sk, const float* c, long long c_sb,
                   long long c_sk, long long c_sm, float* out,
                   long long rows, int n, int k, int m, unsigned blocks,
                   cudaStream_t st) {
  ordered_matmul_rows<MT><<<blocks, kThreads, 0, st>>>(
      a, a_sb, a_sn, a_sk, c, c_sb, c_sk, c_sm, out, rows, n, k, m, m / MT);
}

template <int MT>
void launch_segment(const float* g, long long g_sr, long long g_sn,
                    long long g_sc, float* out, long long rows, int S,
                    int size, int C, unsigned blocks, cudaStream_t st) {
  segment_sum_rows<MT><<<blocks, kThreads, 0, st>>>(
      g, g_sr, g_sn, g_sc, out, rows, S, size, C, C / MT);
}

}  // namespace

extern "C" {

// a (batch, n, k) and c (batch, k, m) float32 with the given element
// strides (any, zero included), out (batch, n, m) float32 contiguous, all on
// the current device; batch, n, k, m >= 1. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the grid cannot hold; it never synchronises.
int ordered_matmul_f32(const float* a, long long a_sb, long long a_sn,
                       long long a_sk, const float* c, long long c_sb,
                       long long c_sk, long long c_sm, float* out,
                       long long batch, int n, int k, int m, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  if (batch > LLONG_MAX / n) return (int)cudaErrorInvalidValue;
  const long long rows = batch * n;
  const int mt = outputs_per_thread(m);
  unsigned blocks;
  if (!grid_of(rows, m / mt, &blocks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mt == 4)
    launch_matmul<4>(a, a_sb, a_sn, a_sk, c, c_sb, c_sk, c_sm, out, rows, n,
                     k, m, blocks, st);
  else if (mt == 2)
    launch_matmul<2>(a, a_sb, a_sn, a_sk, c, c_sb, c_sk, c_sm, out, rows, n,
                     k, m, blocks, st);
  else
    launch_matmul<1>(a, a_sb, a_sn, a_sk, c, c_sb, c_sk, c_sm, out, rows, n,
                     k, m, blocks, st);
  return (int)cudaGetLastError();
}

// g (R, S*size, C) float32 with the given element strides, out (R, S, C)
// float32 contiguous, both on the current device; R, S, size, C >= 1.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the grid cannot hold; it never
// synchronises.
int segment_sum_f32(const float* g, long long g_sr, long long g_sn,
                    long long g_sc, float* out, long long R, int S, int size,
                    int C, void* stream) {
  if (R <= 0 || S <= 0 || size <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  if (R > LLONG_MAX / S) return (int)cudaErrorInvalidValue;
  const long long rows = R * S;
  const int mt = outputs_per_thread(C);
  unsigned blocks;
  if (!grid_of(rows, C / mt, &blocks)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mt == 4)
    launch_segment<4>(g, g_sr, g_sn, g_sc, out, rows, S, size, C, blocks, st);
  else if (mt == 2)
    launch_segment<2>(g, g_sr, g_sn, g_sc, out, rows, S, size, C, blocks, st);
  else
    launch_segment<1>(g, g_sr, g_sn, g_sc, out, rows, S, size, C, blocks, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
