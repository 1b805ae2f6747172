// Yardsticks for the MI kernel (src/repro_torch/csrc/mi_score.cu), built and
// timed by chip_smoke.py beside it; nothing in the package calls them.
//
//   * mi_scores_baseline_launch: the kernel's former design, kept as it was
//     so that one run times the old and the new kernel on the same card. One
//     thread per table, which walks its V*C counts alone (a warp's 32 lanes
//     read 32 tables V*C*4 bytes apart), and every cell rebuilds its column
//     marginal (V divisions a cell). It takes a contiguous (F, V, C) stack.
//   * empty_launch: an empty kernel launched through the same ctypes path,
//     the floor under any launch of a kernel from Python.
//
// Plain C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;

template <typename T>
__global__ void mi_rows_kernel(const T* __restrict__ counts, int64_t rows,
                               int v_count, int c_count, float* __restrict__ out) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= rows) return;
  const T* tab = counts + f * (int64_t)(v_count * c_count);

  float total = 0.f;
  for (int v = 0; v < v_count; ++v) {
    float row = 0.f;
    for (int c = 0; c < c_count; ++c) row = __fadd_rn(row, (float)tab[v * c_count + c]);
    total = __fadd_rn(total, row);
  }
  total = fmaxf(total, 1.f);

  float mi = 0.f;
  for (int v = 0; v < v_count; ++v) {
    float px = 0.f;
    for (int c = 0; c < c_count; ++c) {
      px = __fadd_rn(px, __fdiv_rn((float)tab[v * c_count + c], total));
    }
    float row = 0.f;
    for (int c = 0; c < c_count; ++c) {
      const float p = __fdiv_rn((float)tab[v * c_count + c], total);
      float py = 0.f;
      for (int w = 0; w < v_count; ++w) {
        py = __fadd_rn(py, __fdiv_rn((float)tab[w * c_count + c], total));
      }
      const float ratio = __fdiv_rn(p, fmaxf(__fmul_rn(px, py), kEps));
      const float term = p > 0.f ? __fmul_rn(p, logf(fmaxf(ratio, kEps))) : 0.f;
      row = __fadd_rn(row, term);
    }
    mi = __fadd_rn(mi, row);
  }
  out[f] = mi;
}

__global__ void empty_kernel(float* out) {}

template <typename T>
void launch(const void* counts, int64_t rows, int v_count, int c_count,
            float* out, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  mi_rows_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(counts), rows, v_count, c_count, out);
}

}  // namespace

// counts_dtype: 0 int32, 1 float32. `counts` is a contiguous (rows, V, C)
// table stack; `out` receives rows float32 values.
extern "C" int mi_scores_baseline_launch(const void* counts, int counts_dtype, int64_t rows,
                                         int v_count, int c_count, void* out, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (counts_dtype) {
    case 0: launch<int32_t>(counts, rows, v_count, c_count, o, s); break;
    case 1: launch<float>(counts, rows, v_count, c_count, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One block of 32 threads that does nothing with `out`.
extern "C" int empty_launch(void* out, void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out));
  return (int)cudaGetLastError();
}
