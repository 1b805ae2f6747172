// Contingency tables on Hopper: out[f, v, c] = #{m : X[m, f] == v, y[m] == c}.
//
// Replaces the TPU kernel src/repro/kernels/contingency.py::
// contingency_tables_pallas (body `_kernel`). That kernel recasts the
// histogram as a one-hot matmul because the TPU has no fast scatter; here
// the histogram is counted directly, so no one-hot tile is ever built.
//
// Bound on this card: bytes. Each element of X is read once and costs one
// compare and one increment, so at one byte per element (int8 X) the
// kernel needs M*F bytes from device memory against roughly M*F integer
// operations: far below the ~20 operations per byte where the SMs, and not
// HBM, would become the limit.
//
// What the design does about it:
//   * Every element of X is read exactly once, in its own type (int8, uint8,
//     int16, int32 or int64): no widened or padded copy of X is made.
//   * A warp's 32 lanes read 32 neighbouring elements, so loads coalesce in
//     either layout: lanes run over features for the row-major (M, F) layout
//     and over rows for the feature-major layout (the wrapper picks by the
//     strides; there is no transpose copy).
//   * Counts live in shared memory, one private column per thread, so the
//     inner loop has no atomics and no bank conflicts. A block adds its
//     table to the int32 output with one global atomic per non-zero cell.
//     Integer atomics make the result exact and independent of order.
//   * Out-of-range values (negatives, the 2**31-1 padding sentinel) and the
//     ragged edges are masked in the loop, so no padded input is needed.
//   * Tables too large for shared memory use the global-atomic variant below.
//
// Plain C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Layout {
  int64_t m, f, stride_m, stride_f;
  int v_count, vc_count;
  int tf_count, tr_count;  // features x row lanes in one block
  int lanes_on_rows;       // 1: adjacent lanes take adjacent rows
  int64_t rows_per_chunk;  // rows covered by one blockIdx.y
};

__device__ __forceinline__ void thread_coords(const Layout& L, int t, int& tf, int& tr) {
  if (L.lanes_on_rows) {
    tf = t / L.tr_count;
    tr = t % L.tr_count;
  } else {
    tr = t / L.tf_count;
    tf = t % L.tf_count;
  }
}

template <typename T>
__global__ void contingency_smem_kernel(const T* __restrict__ x,
                                        const int32_t* __restrict__ y,
                                        Layout L, int32_t* __restrict__ out) {
  extern __shared__ int32_t table[];  // cells rows x blockDim.x private columns
  const int cells = L.v_count * L.vc_count;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = t; i < cells * nthreads; i += nthreads) table[i] = 0;
  __syncthreads();

  int tf, tr;
  thread_coords(L, t, tf, tr);
  const int64_t f = (int64_t)blockIdx.x * L.tf_count + tf;
  const int64_t m0 = (int64_t)blockIdx.y * L.rows_per_chunk;
  const int64_t m1 = m0 + L.rows_per_chunk < L.m ? m0 + L.rows_per_chunk : L.m;
  if (f < L.f) {
    const T* col = x + f * L.stride_f;
#pragma unroll 8
    for (int64_t r = m0 + tr; r < m1; r += L.tr_count) {
      const int64_t xv = (int64_t)col[r * L.stride_m];
      const int32_t yv = y[r];
      if (xv >= 0 && xv < L.v_count && yv >= 0 && yv < L.vc_count) {
        table[((int)xv * L.vc_count + yv) * nthreads + t] += 1;
      }
    }
  }
  __syncthreads();

  // Sum the row lanes of each feature; one global atomic per non-zero cell.
  for (int i = t; i < L.tf_count * cells; i += nthreads) {
    const int ftile = i / cells;
    const int cell = i % cells;
    const int64_t fg = (int64_t)blockIdx.x * L.tf_count + ftile;
    if (fg >= L.f) continue;
    int32_t s = 0;
    for (int lane = 0; lane < L.tr_count; ++lane) {
      const int owner = L.lanes_on_rows ? ftile * L.tr_count + lane
                                        : lane * L.tf_count + ftile;
      s += table[cell * nthreads + owner];
    }
    if (s) atomicAdd(out + fg * cells + cell, s);
  }
}

template <typename T>
__global__ void contingency_global_kernel(const T* __restrict__ x,
                                          const int32_t* __restrict__ y,
                                          Layout L, int32_t* __restrict__ out) {
  int tf, tr;
  thread_coords(L, threadIdx.x, tf, tr);
  const int64_t f = (int64_t)blockIdx.x * L.tf_count + tf;
  if (f >= L.f) return;
  const int64_t m0 = (int64_t)blockIdx.y * L.rows_per_chunk;
  const int64_t m1 = m0 + L.rows_per_chunk < L.m ? m0 + L.rows_per_chunk : L.m;
  const T* col = x + f * L.stride_f;
  int32_t* table = out + f * (int64_t)(L.v_count * L.vc_count);
  for (int64_t r = m0 + tr; r < m1; r += L.tr_count) {
    const int64_t xv = (int64_t)col[r * L.stride_m];
    const int32_t yv = y[r];
    if (xv >= 0 && xv < L.v_count && yv >= 0 && yv < L.vc_count) {
      atomicAdd(table + (int)xv * L.vc_count + yv, 1);
    }
  }
}

template <typename T>
void launch(const void* x, const int32_t* y, const Layout& L, int row_chunks,
            int use_smem, int32_t* out, cudaStream_t stream) {
  const int threads = L.tf_count * L.tr_count;
  const dim3 grid((unsigned)((L.f + L.tf_count - 1) / L.tf_count), (unsigned)row_chunks);
  if (use_smem) {
    const size_t smem = (size_t)L.v_count * L.vc_count * threads * sizeof(int32_t);
    contingency_smem_kernel<T><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(x), y, L, out);
  } else {
    contingency_global_kernel<T><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), y, L, out);
  }
}

}  // namespace

// x_dtype: 0 int8, 1 uint8, 2 int16, 3 int32, 4 int64. Strides in elements.
// `out` must hold f * v_count * vc_count zeroed int32 counts.
extern "C" int contingency_tables_launch(
    const void* x, int x_dtype, int64_t m, int64_t f, int64_t stride_m,
    int64_t stride_f, const void* y, int v_count, int vc_count, int tf_count,
    int tr_count, int lanes_on_rows, int64_t rows_per_chunk, int row_chunks,
    int use_smem, void* out, void* stream) {
  const Layout L{m, f, stride_m, stride_f, v_count, vc_count,
                 tf_count, tr_count, lanes_on_rows, rows_per_chunk};
  const int32_t* yy = static_cast<const int32_t*>(y);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: launch<int8_t>(x, yy, L, row_chunks, use_smem, o, s); break;
    case 1: launch<uint8_t>(x, yy, L, row_chunks, use_smem, o, s); break;
    case 2: launch<int16_t>(x, yy, L, row_chunks, use_smem, o, s); break;
    case 3: launch<int32_t>(x, yy, L, row_chunks, use_smem, o, s); break;
    case 4: launch<int64_t>(x, yy, L, row_chunks, use_smem, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
