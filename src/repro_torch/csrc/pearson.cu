// Pearson correlation of rows on Hopper, standardisation fused:
//
//   corr[f, t] = mean_m( (X[f,m] - mu_x[f]) / sd_x[f] * (Y[t,m] - mu_y[t]) / sd_y[t] )
//
// with two-pass row statistics (mean, then mean squared deviation) and each
// standard deviation clamped at 1e-12, so a constant row correlates 0.
//
// Replaces the TPU kernel src/repro/kernels/pearson.py::pearson_corr_pallas
// (body `_kernel`, row statistics `_row_stats`), the hot loop of the paper's
// Listing-8 score (PearsonMIScore) on the alternative encoding: one call per
// greedy pick, with T = 1 (the class, then each selected feature's row).
//
// Bound on this card: bytes. At T = 1 each element of X is read once for
// two flops of product and two of statistics: 4 bytes against ~5 flops, far
// below the ~20 flops per byte where the SMs would set the limit. The floor
// is one read of X: 2.0 GB, 0.597 ms, at 50,000 features x 10,000
// observations.
//
// What the design does about it:
//   * One block per feature row. The block reads its row from device memory
//     once, coalesced, into shared memory, takes the mean from that read,
//     and then, from shared memory, the squared deviations and the products
//     against every standardised Y row in one more sweep. X is never
//     standardised into a copy. Rows up to 12,248 floats (what 48 KB holds
//     beside the reduction scratch) are read from HBM once; a longer row is
//     read again for the second sweep.
//   * The statistics of Y (T rows, small) come from a second kernel of this
//     source, which writes the standardised rows once to a scratch buffer
//     the wrapper allocates; every block then reads them from L2.
//   * The product is this kernel's own loop: no matrix library. Y rows go in
//     groups of 4 accumulators, so any T works with bounded registers.
//   * Block sums reduce with warp shuffles and then over the 8 warps in a
//     fixed order: the result is deterministic.
//   * X must be contiguous along M (feature-major rows, any row stride); the
//     alternative engine makes one feature-major copy per fit for this.
//
// Plain C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTGroup = 4;  // Y rows per sweep
constexpr float kEps = 1e-12f;
// Rows longer than this (in floats) are not staged in shared memory.
constexpr int64_t kStageMax = 48 * 1024 / sizeof(float) - kWarps * (kTGroup + 1);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of K values; every thread receives the same totals.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * K + k];
    v[k] = s;
  }
  __syncthreads();  // scratch may be reused
}

// ys[t, :] = (Y[t, :] - mean) / max(sd, eps), one block per row.
__global__ void standardize_rows_kernel(const float* __restrict__ y, int64_t m,
                                        int64_t ld_y, float* __restrict__ ys) {
  __shared__ float scratch[kWarps];
  const float* row = y + (int64_t)blockIdx.x * ld_y;
  float* dst = ys + (int64_t)blockIdx.x * m;
  float s[1] = {0.f};
  for (int64_t i = threadIdx.x; i < m; i += kThreads) s[0] += row[i];
  block_sum<1>(s, scratch);
  const float mu = s[0] / (float)m;
  float q[1] = {0.f};
  for (int64_t i = threadIdx.x; i < m; i += kThreads) {
    const float d = row[i] - mu;
    q[0] += d * d;
  }
  block_sum<1>(q, scratch);
  const float sd = fmaxf(sqrtf(q[0] / (float)m), kEps);
  for (int64_t i = threadIdx.x; i < m; i += kThreads) dst[i] = (row[i] - mu) / sd;
}

template <bool STAGED>
__global__ void pearson_rows_kernel(const float* __restrict__ x, int64_t m, int64_t ld_x,
                                    const float* __restrict__ ys, int t_count,
                                    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* scratch = smem;                          // kWarps * (kTGroup + 1)
  float* row_s = smem + kWarps * (kTGroup + 1);   // m floats when STAGED
  const int64_t f = blockIdx.x;
  const float* row = x + f * ld_x;

  float s[1] = {0.f};
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < m; i += kThreads) {
    const float v = row[i];
    if (STAGED) row_s[i] = v;
    s[0] += v;
  }
  block_sum<1>(s, scratch);  // its barrier also publishes row_s
  const float mu = s[0] / (float)m;
  const float* src = STAGED ? row_s : row;

  float inv_sd = 0.f;
  for (int t0 = 0; t0 < t_count; t0 += kTGroup) {
    float acc[kTGroup + 1];
#pragma unroll
    for (int u = 0; u <= kTGroup; ++u) acc[u] = 0.f;
    for (int64_t i = threadIdx.x; i < m; i += kThreads) {
      const float d = src[i] - mu;
      if (t0 == 0) acc[kTGroup] += d * d;
#pragma unroll
      for (int u = 0; u < kTGroup; ++u) {
        if (t0 + u < t_count) acc[u] += d * ys[(int64_t)(t0 + u) * m + i];
      }
    }
    block_sum<kTGroup + 1>(acc, scratch);
    if (t0 == 0) inv_sd = 1.f / fmaxf(sqrtf(acc[kTGroup] / (float)m), kEps);
    if (threadIdx.x == 0) {
      for (int u = 0; u < kTGroup && t0 + u < t_count; ++u) {
        out[f * t_count + t0 + u] = acc[u] * inv_sd / (float)m;
      }
    }
  }
}

}  // namespace

// x: (f_count, m) float32 rows, contiguous along m, rows `ld_x` apart.
// y: (t_count, m) float32 rows, contiguous along m, rows `ld_y` apart.
// ys: scratch of t_count * m floats. out: contiguous (f_count, t_count).
extern "C" int pearson_corr_launch(const void* x, int64_t f_count, int64_t m, int64_t ld_x,
                                   const void* y, int t_count, int64_t ld_y, void* ys,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ysf = static_cast<float*>(ys);
  standardize_rows_kernel<<<(unsigned)t_count, kThreads, 0, s>>>(
      static_cast<const float*>(y), m, ld_y, ysf);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t scratch = kWarps * (kTGroup + 1) * sizeof(float);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (m <= kStageMax) {
    pearson_rows_kernel<true><<<(unsigned)f_count, kThreads, scratch + m * sizeof(float), s>>>(
        xf, m, ld_x, ysf, t_count, o);
  } else {
    pearson_rows_kernel<false><<<(unsigned)f_count, kThreads, scratch, s>>>(
        xf, m, ld_x, ysf, t_count, o);
  }
  return (int)cudaGetLastError();
}
