// Quantile-bin codes on Hopper: out[b, n] = #{k < E : edges[n, k] <= X[b, n]}.
//
// Replaces the TPU kernel src/repro/kernels/binning.py::bin_codes_pallas
// (body `_kernel`): the device half of the binned streaming fit, which
// encodes each raw float32 block ahead of the contingency count, and of the
// in-memory binned fit, which encodes the whole matrix once.
//
// The compare-sum equals searchsorted(edges[n], x, side="right") for every
// x, ties included (x equal to an edge goes to the upper bin, -0.0 compares
// equal to 0.0, +inf passes every edge, -inf none). NaN compares false
// against every edge, where searchsorted sorts it past them all: one select
// after the compare-sum gives it E, as the host binner and the plain
// version do. A fitted binner handed to BinnedSource meets NaN without the
// sketch pass that would refuse it, so NaN does reach this kernel.
//
// Bound on this card: bytes at the main path's bins=16 (E = 15). Each
// element is read once (4 bytes) and its code written once (4 bytes):
// 0.157 ms for a 65,536 x 1000 block and 2.39 ms for 1,000,000 x 1000 at
// 3.35 TB/s. The compare-sum costs about 2E issue slots per element (a
// compare and an add), ~32 at E = 15 against ~36 the SMs can issue per
// element at the byte bound; at E = 63 (~128) the operations, not the
// bytes, set the floor.
//
// What the design does about it (the path is picked on the host, by
// kernels/binning.py::bin_codes_plan):
//   * At E <= 16 each lane owns FPL = 4 neighbouring features and moves
//     them with one 16-byte load per row and one streaming store of their
//     codes, where X's rows start 16-byte aligned; a warp covers 128
//     features of a row. Other views, and E > 16, take one feature per lane
//     (4-byte loads and stores, any row stride).
//   * The lane's FPL x ECAP edges sit in registers (at most 64), loaded once
//     per work item, so the inner loop is register compares only; slots
//     past E hold NaN, which compares false. E > 64 reads the edges through
//     the read-only cache.
//   * Eight rows in flight per thread, and a persistent grid (SMs x resident
//     blocks) walking (feature tile, row range) work items in place of one
//     ragged wave.
//   * X is read through a row stride, so a ragged or padded streaming block,
//     or a row slice, needs no copy.
//
// Plain C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 8;  // rows in flight per thread

struct Args {
  const float* x;
  int64_t rows, feats, ld_x;
  const float* edges;  // (feats, num_edges) row-major
  int num_edges;
  int64_t rows_per_item;
  int64_t feat_items;
  int64_t items;
  int32_t* out;  // (rows, feats) row-major
};

template <int FPL>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void store(int32_t* p, const int32_t (&c)[4]) {
    __stcs(reinterpret_cast<int4*>(p), make_int4(c[0], c[1], c[2], c[3]));
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(int32_t* p, const int32_t (&c)[1]) {
    __stcs(p, c[0]);
  }
};

// Slots past the real edges hold NaN, which compares false against every
// value (+inf and NaN included), so the count needs no bound check. A NaN
// value counts no edge either and takes the top code, E, after the sum
// (counting !(v < edge) instead would count every NaN slot too).
template <int ECAP>
__device__ __forceinline__ int32_t count_le(const float (&e)[ECAP], float v, int num_edges) {
  int32_t c = 0;
#pragma unroll
  for (int k = 0; k < ECAP; ++k) c += e[k] <= v ? 1 : 0;
  return v != v ? num_edges : c;
}

template <int FPL, int ECAP>
__global__ void __launch_bounds__(256, 2) bin_codes_reg_kernel(Args a) {
  constexpr int FT = kWarp * FPL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int64_t item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int64_t ft = item % a.feat_items, rt = item / a.feat_items;
    const int64_t n0 = ft * FT + (int64_t)lane * FPL;
    if (n0 >= a.feats) continue;  // FPL divides feats: a lane's features are all in or all out
    float e[FPL][ECAP];
#pragma unroll
    for (int j = 0; j < FPL; ++j)
#pragma unroll
      for (int k = 0; k < ECAP; ++k)
        e[j][k] = k < a.num_edges ? __ldg(a.edges + (n0 + j) * a.num_edges + k)
                                  : __int_as_float(0x7fc00000);

    const int64_t r0 = rt * a.rows_per_item;
    const int64_t r1 = r0 + a.rows_per_item < a.rows ? r0 + a.rows_per_item : a.rows;
    int64_t r = r0 + warp;
    const int64_t step = nwarps;
    for (; r + (kRows - 1) * step < r1; r += kRows * step) {
      float v[kRows][FPL];
#pragma unroll
      for (int u = 0; u < kRows; ++u) Vec<FPL>::load(a.x + (r + u * step) * a.ld_x + n0, v[u]);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        int32_t c[FPL];
#pragma unroll
        for (int j = 0; j < FPL; ++j) c[j] = count_le<ECAP>(e[j], v[u][j], a.num_edges);
        Vec<FPL>::store(a.out + (r + u * step) * a.feats + n0, c);
      }
    }
    for (; r < r1; r += step) {
      float v[FPL];
      Vec<FPL>::load(a.x + r * a.ld_x + n0, v);
      int32_t c[FPL];
#pragma unroll
      for (int j = 0; j < FPL; ++j) c[j] = count_le<ECAP>(e[j], v[j], a.num_edges);
      Vec<FPL>::store(a.out + r * a.feats + n0, c);
    }
  }
}

__global__ void __launch_bounds__(256) bin_codes_any_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int64_t item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int64_t ft = item % a.feat_items, rt = item / a.feat_items;
    const int64_t n = ft * kWarp + lane;
    if (n >= a.feats) continue;
    const float* e = a.edges + n * a.num_edges;
    const int64_t r0 = rt * a.rows_per_item;
    const int64_t r1 = r0 + a.rows_per_item < a.rows ? r0 + a.rows_per_item : a.rows;
    for (int64_t r = r0 + warp; r < r1; r += nwarps) {
      const float v = __ldg(a.x + r * a.ld_x + n);
      int32_t c = 0;
      for (int k = 0; k < a.num_edges; ++k) c += __ldg(e + k) <= v ? 1 : 0;
      __stcs(a.out + r * a.feats + n, v != v ? a.num_edges : c);
    }
  }
}

}  // namespace

// x: (rows, feats) float32, features contiguous, rows `ld_x` elements apart.
// edges: contiguous (feats, num_edges) float32, each row sorted ascending.
// out: contiguous (rows, feats) int32. fpl (features per lane: 4 or 1;
// 0 for the E > 64 kernel), threads and the work split come from
// kernels/binning.py::bin_codes_plan; a work item is a tile of 32 * fpl
// features x rows_per_item rows.
extern "C" int bin_codes_launch(const void* x, int64_t rows, int64_t feats, int64_t ld_x,
                                const void* edges, int num_edges, int fpl, int threads,
                                int64_t rows_per_item, int64_t feat_items, int64_t items,
                                int grid, void* out, void* stream) {
  const Args a{static_cast<const float*>(x), rows, feats, ld_x,
               static_cast<const float*>(edges), num_edges, rows_per_item, feat_items,
               items, static_cast<int32_t*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fpl == 4 && num_edges <= 16) {
    bin_codes_reg_kernel<4, 16><<<grid, threads, 0, s>>>(a);
  } else if (fpl == 1 && num_edges <= 16) {
    bin_codes_reg_kernel<1, 16><<<grid, threads, 0, s>>>(a);
  } else if (fpl == 1 && num_edges <= 32) {
    bin_codes_reg_kernel<1, 32><<<grid, threads, 0, s>>>(a);
  } else if (fpl == 1 && num_edges <= 64) {
    bin_codes_reg_kernel<1, 64><<<grid, threads, 0, s>>>(a);
  } else if (fpl == 0) {
    bin_codes_any_kernel<<<grid, threads, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
