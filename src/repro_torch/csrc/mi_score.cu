// Mutual information (nats) of stacked contingency tables: (F, V, C) -> (F,).
//
//   MI_f = sum_v sum_c p log(p / (p_v p_c)),   p = counts_f / max(total_f, 1)
//
// Replaces the TPU kernel src/repro/kernels/mi_score.py::mi_scores_pallas
// (body `_kernel`), which is the function src/repro/core/scores.py::
// mi_from_counts computes; the port finalizes every scoring pass here.
//
// Bound on this card: bytes, and in practice launch latency. A table is
// V*C counts (16 bytes for the paper's binary data) read once, against a few
// dozen flops and V*C logarithms per row: a 50,000-feature pass moves about
// 1 MB, microseconds of HBM time, so one launch per pass is the real cost.
//
// What the design does about it: one thread per table row reads its counts
// straight from the contingency kernel's int32 output (no float copy, no
// intermediate p, px*py or term arrays in device memory) and writes one
// float. The sums run in the plain version's order (over c, then over v) with
// explicitly rounded multiplies and adds, so no fused multiply-add changes
// the rounding: the result is deterministic and differs from the plain
// PyTorch version only where logf does.
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
extern "C" int mi_scores_launch(const void* counts, int counts_dtype, int64_t rows,
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
