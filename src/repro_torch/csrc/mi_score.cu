// Mutual information (nats) of stacked contingency tables: (F, V, C) -> (F,).
//
//   MI_f = sum_v sum_c p log(p / max(px py, 1e-12)),   p = n / max(total, 1),
//
// px the row (value) and py the column (class) marginals, a term of a cell
// with p = 0 is 0, and the ratio is clamped at 1e-12 before the log: the body
// `_kernel` of the TPU kernel src/repro/kernels/mi_score.py::mi_scores_pallas,
// which is what src/repro/core/scores.py::mi_from_counts computes. The port
// finalizes every scoring pass here.
//
// Bound on this card: bytes, and in practice the launch. A pass reads V*C
// counts a table once (16 KB for 1000 tables of 2 x 2 int32, 1 MB for 1000
// of 16 x 16) against ~10 instructions and one logarithm a cell: well under
// a microsecond of HBM time at every main-path shape, so a launch (a few
// microseconds) is the floor the kernel can reach.
//
// What the design does about it:
//   * Cooperative tables, loads coalesced. Where V*C <= 32, a group of
//     G = next power of two >= V*C lanes owns a table, one cell a lane, and
//     a warp holds 32 / G tables: 8 tables of 2 x 2 int32 are one 128-byte
//     load. Larger tables take a warp each, lanes striding over the cells.
//   * Marginals once per table. Small tables sum their rows and columns with
//     shuffles inside the group; large ones in a (V + C)-float slice of
//     shared memory per warp (global scratch beyond 48 KB a block). That is
//     one division per cell for p and one per marginal, against V per cell
//     when every cell rebuilt its column marginal.
//   * Strided input. A table is addressed through (outer, inner, V, C)
//     strides, so the class-major view of a conditional (F, V, W, C) stack
//     that cmi_from_counts hands over (F tables of C slices) is read in
//     place, with no copy.
//   * Deterministic. Every table reduces in one fixed order (sums of counts
//     in cell order, the terms through a fixed butterfly), with explicitly
//     rounded multiplies and adds and no atomics: two equal tables give
//     bit-equal MI wherever they sit, so a tie between candidates falls as
//     the plain version's argmax falls. The log is logf, not __logf.
//   * A grid sized from the table count; the wrapper makes one allocation.
//
// Plain C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

struct Tables {
  const void* counts;
  int64_t tables;          // outer * inner tables, in output order
  int64_t inner;           // tables per outer index (1 for a 3-D stack)
  int64_t s_outer, s_inner, s_v, s_c;  // element strides
  int v_count, c_count;
  float* out;
};

template <typename T>
__device__ __forceinline__ float cell(const T* tab, const Tables& a, int v, int c) {
  return (float)__ldg(tab + v * a.s_v + c * a.s_c);
}

template <typename T>
__device__ __forceinline__ const T* table_base(const Tables& a, int64_t t) {
  const int64_t o = t / a.inner, i = t - o * a.inner;
  return static_cast<const T*>(a.counts) + o * a.s_outer + i * a.s_inner;
}

// p log(p / max(px py, eps)) for p > 0, else 0: the plain version's term.
__device__ __forceinline__ float mi_term(float p, float px, float py) {
  const float ratio = __fdiv_rn(p, fmaxf(__fmul_rn(px, py), kEps));
  return p > 0.f ? __fmul_rn(p, logf(fmaxf(ratio, kEps))) : 0.f;
}

// One table per group of G lanes (V * C <= G <= 32), lane l holding cell
// (l / C, l % C); lanes past V * C and groups past the last table hold 0.
template <typename T, int G>
__global__ void __launch_bounds__(256) mi_tables_group_kernel(Tables a) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t t = gid / G;
  const int l = (int)(gid % G);
  const int cells = a.v_count * a.c_count;
  const int v = l / max(a.c_count, 1), c = l - v * a.c_count;
  const bool live = t < a.tables && l < cells;
  const float n = live ? cell(table_base<T>(a, t), a, v, c) : 0.f;

  float total = n;
#pragma unroll
  for (int k = G / 2; k > 0; k >>= 1) total = __fadd_rn(total, __shfl_xor_sync(kFull, total, k, G));
  total = fmaxf(total, 1.f);
  float row = 0.f, col = 0.f;  // this cell's row and column sums, in cell order
  for (int k = 0; k < a.c_count; ++k) row = __fadd_rn(row, __shfl_sync(kFull, n, v * a.c_count + k, G));
  for (int k = 0; k < a.v_count; ++k) col = __fadd_rn(col, __shfl_sync(kFull, n, k * a.c_count + c, G));

  float term = live ? mi_term(__fdiv_rn(n, total), __fdiv_rn(row, total), __fdiv_rn(col, total)) : 0.f;
#pragma unroll
  for (int k = G / 2; k > 0; k >>= 1) term = __fadd_rn(term, __shfl_xor_sync(kFull, term, k, G));
  if (l == 0 && t < a.tables) a.out[t] = term;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, k));
  return x;
}

// One table per warp (V * C > 32). Lane l walks cells l, l + 32, ... in
// (v, c) form, stepped without a division. The marginals px (V floats) and
// py (C floats) sit in shared memory, V + C floats a warp, or in `scratch`
// (global memory, the same slice a warp) where that is set.
template <typename T>
__global__ void __launch_bounds__(256) mi_tables_warp_kernel(Tables a, float* scratch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gwarp = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  const int64_t nwarps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int V = a.v_count, C = a.c_count;
  const int dv = 32 / C, dc = 32 - dv * C, v0 = lane / C, c0 = lane - v0 * C;
  float* px = scratch ? scratch + gwarp * (V + C) : smem + warp * (V + C);
  float* py = px + V;
  for (int64_t t = gwarp; t < a.tables; t += nwarps) {
    const T* tab = table_base<T>(a, t);
    float s = 0.f;
    for (int v = v0, c = c0; v < V;) {
      s = __fadd_rn(s, cell(tab, a, v, c));
      c += dc, v += dv;
      if (c >= C) c -= C, ++v;
    }
    const float total = fmaxf(warp_sum(s), 1.f);
    for (int v = lane; v < V; v += 32) {
      float r = 0.f;
      for (int c = 0; c < C; ++c) r = __fadd_rn(r, cell(tab, a, v, c));
      px[v] = __fdiv_rn(r, total);
    }
    for (int c = lane; c < C; c += 32) {
      float r = 0.f;
      for (int v = 0; v < V; ++v) r = __fadd_rn(r, cell(tab, a, v, c));
      py[c] = __fdiv_rn(r, total);
    }
    __syncwarp();
    float acc = 0.f;
    for (int v = v0, c = c0; v < V;) {
      acc = __fadd_rn(acc, mi_term(__fdiv_rn(cell(tab, a, v, c), total), px[v], py[c]));
      c += dc, v += dv;
      if (c >= C) c -= C, ++v;
    }
    acc = warp_sum(acc);
    if (lane == 0) a.out[t] = acc;
    __syncwarp();  // the next table overwrites px and py
  }
}

template <typename T>
int launch(const Tables& a, int group, int threads, int grid, int smem_bytes,
           float* scratch, cudaStream_t s) {
  switch (group) {
    case 1: mi_tables_group_kernel<T, 1><<<grid, threads, 0, s>>>(a); break;
    case 2: mi_tables_group_kernel<T, 2><<<grid, threads, 0, s>>>(a); break;
    case 4: mi_tables_group_kernel<T, 4><<<grid, threads, 0, s>>>(a); break;
    case 8: mi_tables_group_kernel<T, 8><<<grid, threads, 0, s>>>(a); break;
    case 16: mi_tables_group_kernel<T, 16><<<grid, threads, 0, s>>>(a); break;
    case 32: mi_tables_group_kernel<T, 32><<<grid, threads, 0, s>>>(a); break;
    case 0: mi_tables_warp_kernel<T><<<grid, threads, smem_bytes, s>>>(a, scratch); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// counts_dtype: 0 int32, 1 float32. Table t = o * inner + i (o < tables /
// inner) starts at counts + o * s_outer + i * s_inner, cell (v, c) at
// + v * s_v + c * s_c (element strides); out receives `tables` float32
// values in t order. group (lanes a table: 1-32, or 0 for a warp a table),
// threads, grid, the shared bytes and the scratch (global marginals of the
// warp path, grid * threads / 32 * (V + C) floats, or null) come from
// kernels/mi_score.py::mi_plan.
extern "C" int mi_scores_launch(const void* counts, int counts_dtype, int64_t tables,
                                int64_t inner, int64_t s_outer, int64_t s_inner,
                                int64_t s_v, int64_t s_c, int v_count, int c_count,
                                int group, int threads, int grid, int smem_bytes,
                                void* scratch, void* out, void* stream) {
  const Tables a{counts, tables, inner, s_outer, s_inner, s_v, s_c, v_count, c_count,
                 static_cast<float*>(out)};
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (counts_dtype) {
    case 0: return launch<int32_t>(a, group, threads, grid, smem_bytes, sc, s);
    case 1: return launch<float>(a, group, threads, grid, smem_bytes, sc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
