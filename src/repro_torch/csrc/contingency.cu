// Contingency tables on Hopper: out[f, v, c] = #{m : X[m, f] == v, y[m] == c}.
//
// Replaces the TPU kernel src/repro/kernels/contingency.py::
// contingency_tables_pallas (body `_kernel`), and through it
// conditional_tables_pallas (the class fused into the target). That kernel
// recasts the histogram as a one-hot matmul because the TPU has no fast
// scatter; here the histogram is counted directly.
//
// Bound on this card: bytes. Each element of X is read once, so the least
// time is (M*F*itemsize + 4*M + 4*F*V*C) / 3.35 TB/s: 0.299 ms for
// CorrAL's 1M x 1000 int8, 1.19 ms for 1M x 1000 int32 codes. Counting has
// to keep up with that: at one byte per element the SMs have ~9 issue
// slots per element at the bound, half of them on the integer pipe, so an
// element may cost a few integer operations and no more.
//
// What the design does about it (the path is picked on the host, by
// kernels/contingency.py::contingency_plan):
//   * Wide loads along the contiguous axis: 16 bytes per lane (16 int8, 8
//     int16, 4 int32 or 2 int64 elements), or 8 bytes where the rows are
//     only 8-byte aligned (CorrAL's 1000-byte rows). A view whose rows break
//     the alignment, or whose contiguous axis has a stride, takes the
//     scalar width (one element per lane, any strides).
//   * Row-major X (what both engines pass: the alternative engine's
//     feature-major X_rows is transposed back before the count): lanes own
//     feature chunks (SWAR: several chunks of VB bytes, so a warp reads 1024
//     bytes of a row, 512 with 8 cells) and a warp takes 32 rows at a time;
//     the 32 targets come in with one coalesced load and are handed to the
//     lanes by shuffles, so the target is read once per row. Feature-major
//     X (a column-major array a caller passes) takes the shared tables with
//     lanes along rows, one feature per warp, and reads the targets of a
//     lane's rows with the same wide loads; no fit passes it.
//   * SWAR (row-major int8 / uint8 with V <= 2 and C <= 4: CorrAL's 4 cells
//     and the class-fused 8): four bytes are tested at once in a 32-bit word
//     (byte < V) and counted in byte lanes in registers; the counts are
//     flushed every 224 rows, before a byte lane can wrap. The counters hold,
//     per class, #valid and #(x == 1); the table is their differences.
//   * Shared tables (other types, up to 227 KB): one int32 table per block
//     for its feature tile, [cell][slot] with slot = element * 32 + lane,
//     so the 32 lanes of a warp hit 32 banks whatever their cells. One
//     shared atomic per element. The feature-major kernel keeps one table
//     per warp, replicated per lane when it fits.
//   * Tables larger than shared memory: one global atomic per element.
//   * A persistent grid (SMs x resident blocks) walks work items, each a
//     feature tile x row range. A block adds its table to the int32 output
//     with one global atomic per non-zero cell. Integer atomics make the
//     result exact and independent of order.
//   * Out-of-range values and targets (negatives, the 2**31-1 sentinel)
//     and ragged edges are masked in the loop: no padded copy of X.
//
// Plain C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Path codes (kernels/contingency.py).
constexpr int kSwar = 0, kShared = 1, kGlobal = 2;

struct Args {
  const void* x;
  int64_t m, f, stride_m, stride_f;  // elements
  const int32_t* y;
  int v, c, cells;
  int32_t* out;  // (f, v, c)
  int64_t rows_per_item;
  int64_t feat_items;  // feature tiles (row-major) or feature groups (feature-major)
  int64_t items;       // feat_items * row ranges
  int replicas;        // feature-major shared tables: copies per warp (1 or 32)
};

// ---------------------------------------------------------------------------
// Loads
// ---------------------------------------------------------------------------

// VB bytes from a VB-aligned address, as 32-bit words (VB = 4, 8 or 16).
template <int VB>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[VB / 4]) {
  if constexpr (VB == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (VB == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x; w[1] = u.y;
  }
}

// W elements of type T from a W*sizeof(T)-aligned address (W > 1), or one.
template <typename T, int W>
__device__ __forceinline__ void load_elems(const T* p, T (&e)[W]) {
  if constexpr (W == 1) {
    e[0] = __ldg(p);
  } else {
    constexpr int VB = W * (int)sizeof(T);
    union { uint32_t w[VB / 4]; T e[W]; } u;
    load_words<VB>(p, u.w);
#pragma unroll
    for (int i = 0; i < W; ++i) e[i] = u.e[i];
  }
}

template <typename T>
__device__ __forceinline__ bool in_range(T x, int v, int64_t& out) {
  out = (int64_t)x;
  return (uint64_t)out < (uint64_t)v;
}

// The first `have` bytes at p (one at a time: a ragged edge), 0xff after.
template <int NW>
__device__ __forceinline__ void partial_words(const uint8_t* p, int have, uint32_t (&w)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t wv = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      wv |= (4 * i + b < have ? (uint32_t)__ldg(p + 4 * i + b) : 0xffu) << (8 * b);
    w[i] = wv;
  }
}

// The targets of W consecutive rows starting at p, `have` of them real:
// 16-byte loads where p is 16-byte aligned and all W are real, else one
// at a time.
template <int W>
__device__ __forceinline__ void load_targets(const int32_t* p, int have, int32_t (&t)[W]) {
  if constexpr (W % 4 == 0) {
    if (have == W && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < W; j += 4) {
        const int4 u = __ldg(reinterpret_cast<const int4*>(p + j));
        t[j] = u.x; t[j + 1] = u.y; t[j + 2] = u.z; t[j + 3] = u.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) t[i] = i < have ? __ldg(p + i) : -1;
}

// Adds one table entry to the output, skipping zeros.
__device__ __forceinline__ void add_out(int32_t* p, int32_t n) {
  if (n) atomicAdd(p, n);
}

// ---------------------------------------------------------------------------
// SWAR, row-major: lanes own VB-byte feature chunks, warps take 32 rows.
// ---------------------------------------------------------------------------

// Byte-lane test on a word of four values b (V <= 2): 0x01 in each byte
// with b < V (unsigned), else 0x00.
__device__ __forceinline__ uint32_t valid01(uint32_t w, uint32_t kv) {
  const uint32_t t = (w & 0x7f7f7f7fu) + kv;  // bit 7 set iff (b & 0x7f) >= V
  return (~(t | w) & 0x80808080u) >> 7;
}

// Per word: t[0] = #valid, t[1] = the value itself (0 or 1) where valid.
template <int NW>
__device__ __forceinline__ void swar_terms(const uint32_t (&w)[NW], uint32_t kv,
                                           uint32_t (&t)[2][NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t ok = valid01(w[i], kv);
    t[0][i] = ok;
    t[1][i] = w[i] & ok;
  }
}

// Raw counters: raw index c * V + k, k = 0 (#valid) or k = 1 (#x == 1).
// The table entry of (value k, class c) is raw(c, k) - raw(c, k + 1).
__device__ __forceinline__ int32_t raw_to_count(const int32_t* tab, int stride, int v, int c,
                                                int k, int slot) {
  const int32_t a = tab[(c * v + k) * stride + slot];
  return k + 1 < v ? a - tab[(c * v + k + 1) * stride + slot] : a;
}

template <int VB, int CMAX>
__global__ void __launch_bounds__(256, 3) contingency_swar_rows(Args a) {
  constexpr int VMAX = 2;
  constexpr int NW = VB / 4;
  // Chunks per lane: a warp covers 1024 bytes of a row (512 for the 8-cell
  // counters, which hold twice the registers).
  constexpr int K = (CMAX > 2 ? 16 : 32) / VB;
  constexpr int KW = K * NW;        // words per lane per row
  constexpr int FT = kWarp * VB * K;  // features per tile
  constexpr int U = 2;              // rows in flight per thread (64 bytes)
  constexpr int kFlushRows = 224;   // < 256: a byte lane never wraps
  // [raw][FT]; the lane's byte j (chunk j / VB) sits in slot j * 32 + lane.
  extern __shared__ int32_t tab[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  const uint32_t kv = (0x80u - (uint32_t)a.v) * 0x01010101u;

  for (int64_t item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int64_t ft = item % a.feat_items, rt = item / a.feat_items;
    const int64_t f0 = ft * FT + (int64_t)lane * VB;  // chunk k starts k * 32 * VB further
    const int64_t r0 = rt * a.rows_per_item;
    const int64_t r1 = r0 + a.rows_per_item < a.m ? r0 + a.rows_per_item : a.m;
    int nvalid[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t fk = f0 + k * kWarp * VB;
      nvalid[k] = fk >= a.f ? 0 : (a.f - fk >= VB ? VB : (int)(a.f - fk));
    }
    for (int i = threadIdx.x; i < a.cells * FT; i += blockDim.x) tab[i] = 0;
    __syncthreads();

    uint32_t acc[CMAX][VMAX][KW];
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
#pragma unroll
      for (int k = 0; k < VMAX; ++k)
#pragma unroll
        for (int i = 0; i < KW; ++i) acc[c][k][i] = 0;

    auto flush = [&]() {
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
#pragma unroll
        for (int k = 0; k < VMAX; ++k)
#pragma unroll
          for (int i = 0; i < KW; ++i) {
            const uint32_t wv = acc[c][k][i];
            if (wv && c < a.c && k < a.v) {
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                const uint32_t n = (wv >> (8 * b)) & 0xffu;
                if (n) atomicAdd(&tab[(c * a.v + k) * FT + (4 * i + b) * kWarp + lane], (int)n);
              }
            }
            acc[c][k][i] = 0;
          }
    };

    int pending = 0;
    for (int64_t g = r0 + (int64_t)warp * kWarp; g < r1; g += (int64_t)nwarps * kWarp) {
      const int nrows = r1 - g < kWarp ? (int)(r1 - g) : kWarp;
      const int32_t ylane = lane < nrows ? __ldg(a.y + g + lane) : -1;
      for (int j = 0; j < nrows; j += U) {
        uint32_t w[U][KW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const uint8_t* row = x + (g + j + u) * a.stride_m + f0;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            uint32_t part[NW];
            if (j + u < nrows && nvalid[k] == VB) {
              load_words<VB>(row + k * kWarp * VB, part);
            } else {  // past the last row or feature: 0xff counts nothing
              partial_words<NW>(row + k * kWarp * VB, j + u < nrows ? nvalid[k] : 0, part);
            }
#pragma unroll
            for (int i = 0; i < NW; ++i) w[u][k * NW + i] = part[i];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int yc = __shfl_sync(kFull, ylane, (j + u) & 31);
          if (j + u < nrows && (unsigned)yc < (unsigned)a.c) {
            uint32_t t[VMAX][KW];
            swar_terms<KW>(w[u], kv, t);
#pragma unroll
            for (int c = 0; c < CMAX; ++c) {
              if (c == yc) {
#pragma unroll
                for (int k = 0; k < VMAX; ++k)
#pragma unroll
                  for (int i = 0; i < KW; ++i) acc[c][k][i] += t[k][i];
              }
            }
          }
        }
      }
      pending += kWarp;
      if (pending > kFlushRows - kWarp) {  // after 7 groups of 32: 224 rows
        flush();
        pending = 0;
      }
    }
    flush();
    __syncthreads();

    // In output order, so a warp's atomics land on neighbouring addresses.
    for (int i = threadIdx.x; i < a.cells * FT; i += blockDim.x) {
      const int fl = i / a.cells, cell = i % a.cells;
      const int64_t fg = ft * FT + fl;
      if (fg >= a.f) break;
      const int k = cell / a.c, c = cell % a.c;
      const int chunk = fl / (kWarp * VB), ln = fl % (kWarp * VB) / VB;
      const int slot = (chunk * VB + fl % VB) * kWarp + ln;
      add_out(a.out + fg * a.cells + cell, raw_to_count(tab, FT, a.v, c, k, slot));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Shared tables, row-major: lanes own W-element feature chunks (W = 1: any
// strides), warps take 32 rows; one shared atomic per element.
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(1024, 1) contingency_shared_rows(Args a) {
  constexpr int FT = kWarp * W;
  constexpr int U = W >= 8 ? 2 : (W == 4 ? 4 : 8);  // rows in flight per thread
  extern __shared__ int32_t tab[];  // [cell][FT], slot = element * 32 + lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const T* x = static_cast<const T*>(a.x);

  for (int64_t item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int64_t ft = item % a.feat_items, rt = item / a.feat_items;
    const int64_t f0 = ft * FT + (int64_t)lane * W;
    const int64_t r0 = rt * a.rows_per_item;
    const int64_t r1 = r0 + a.rows_per_item < a.m ? r0 + a.rows_per_item : a.m;
    const int nvalid = f0 >= a.f ? 0 : (a.f - f0 >= W ? W : (int)(a.f - f0));
    for (int i = threadIdx.x; i < a.cells * FT; i += blockDim.x) tab[i] = 0;
    __syncthreads();

    for (int64_t g = r0 + (int64_t)warp * kWarp; g < r1; g += (int64_t)nwarps * kWarp) {
      const int nrows = r1 - g < kWarp ? (int)(r1 - g) : kWarp;
      const int32_t ylane = lane < nrows ? __ldg(a.y + g + lane) : -1;
      for (int j = 0; j < nrows; j += U) {
        T e[U][W];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T* row = x + (g + j + u) * a.stride_m;
          if (j + u < nrows && nvalid == W) {
            if constexpr (W == 1) {
              e[u][0] = __ldg(row + f0 * a.stride_f);
            } else {
              load_elems<T, W>(row + f0, e[u]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < W; ++i)
              e[u][i] = (j + u < nrows && i < nvalid) ? __ldg(row + f0 + i) : T(-1);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int yc = __shfl_sync(kFull, ylane, (j + u) & 31);
          if (j + u < nrows && (unsigned)yc < (unsigned)a.c) {
#pragma unroll
            for (int i = 0; i < W; ++i) {
              int64_t xv;
              if (in_range(e[u][i], a.v, xv) && i < nvalid)
                atomicAdd(&tab[((int)xv * a.c + yc) * FT + i * kWarp + lane], 1);
            }
          }
        }
      }
    }
    __syncthreads();

    // In output order, so a warp's atomics land on neighbouring addresses.
    for (int i = threadIdx.x; i < a.cells * FT; i += blockDim.x) {
      const int fl = i / a.cells, cell = i % a.cells;
      const int64_t fg = ft * FT + fl;
      if (fg >= a.f) break;
      add_out(a.out + fg * a.cells + cell, tab[cell * FT + (fl % W) * kWarp + fl / W]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Shared tables, feature-major: lanes own W-element row chunks (W = 1: any
// strides) of one feature per warp; one table per warp, `replicas` copies.
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(256, 4) contingency_shared_cols(Args a) {
  constexpr int U = W >= 8 ? 1 : (W == 4 ? 2 : 4);  // chunks in flight per thread
  extern __shared__ int32_t tab[];  // [warp][cell][replica]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const T* x = static_cast<const T*>(a.x);
  const int rep = a.replicas;
  int32_t* wt = tab + (int64_t)warp * a.cells * rep;
  const int mine = lane % rep;

  for (int64_t item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int64_t rt = item / a.feat_items, fgp = item % a.feat_items;
    const int64_t f = fgp * nwarps + warp;
    if (f >= a.f) continue;  // warp-uniform
    const int64_t r0 = rt * a.rows_per_item;
    const int64_t n = r0 + a.rows_per_item < a.m ? a.rows_per_item : a.m - r0;
    for (int i = lane; i < a.cells * rep; i += kWarp) wt[i] = 0;
    __syncwarp();
    const T* col = x + f * a.stride_f;
    for (int64_t q0 = (int64_t)lane * W; q0 < n; q0 += (int64_t)kWarp * W * U) {
      T e[U][W];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t q = q0 + (int64_t)u * kWarp * W;
        if constexpr (W > 1) {
          if (q + W <= n) {
            load_elems<T, W>(col + r0 + q, e[u]);
            continue;
          }
        }
#pragma unroll
        for (int i = 0; i < W; ++i)
          e[u][i] = q + i < n ? __ldg(col + (r0 + q + i) * a.stride_m) : T(-1);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t q = q0 + (int64_t)u * kWarp * W;
        int32_t yc[W];
        load_targets<W>(a.y + r0 + q, q + W <= n ? W : (q < n ? (int)(n - q) : 0), yc);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          int64_t xv;
          if (in_range(e[u][i], a.v, xv) && (unsigned)yc[i] < (unsigned)a.c)
            atomicAdd(&wt[((int)xv * a.c + yc[i]) * rep + mine], 1);
        }
      }
    }
    __syncwarp();
    for (int cell = lane; cell < a.cells; cell += kWarp) {
      int32_t s = 0;
      for (int r = 0; r < rep; ++r) s += wt[cell * rep + r];
      add_out(a.out + f * a.cells + cell, s);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Global atomics: tables too large for shared memory. One element per lane,
// any strides; lanes run along the smaller stride.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) contingency_global(Args a, int lanes_on_rows) {
  const T* x = static_cast<const T*>(a.x);
  const int64_t total = a.m * a.f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = lanes_on_rows ? i % a.m : i / a.f;
    const int64_t f = lanes_on_rows ? i / a.m : i % a.f;
    int64_t xv;
    const int32_t yc = __ldg(a.y + r);
    if (in_range(__ldg(x + r * a.stride_m + f * a.stride_f), a.v, xv) &&
        (unsigned)yc < (unsigned)a.c)
      atomicAdd(a.out + f * a.cells + (int)xv * a.c + yc, 1);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_k(K kernel, int grid, int threads, int smem, cudaStream_t s, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaSuccess;
}

template <int VB>
cudaError_t launch_swar(const Args& a, int cols, int grid, int threads, int smem,
                        cudaStream_t s) {
  if (cols || a.v > 2 || a.c > 4) return cudaErrorInvalidValue;
  if (a.c <= 2) return launch_k(contingency_swar_rows<VB, 2>, grid, threads, smem, s, a);
  return launch_k(contingency_swar_rows<VB, 4>, grid, threads, smem, s, a);
}

template <typename T, int W>
cudaError_t launch_shared_w(const Args& a, int cols, int grid, int threads, int smem,
                            cudaStream_t s) {
  return cols ? launch_k(contingency_shared_cols<T, W>, grid, threads, smem, s, a)
              : launch_k(contingency_shared_rows<T, W>, grid, threads, smem, s, a);
}

template <typename T>
cudaError_t launch_typed(const Args& a, int path, int cols, int vec, int grid, int threads,
                         int smem, cudaStream_t s) {
  if (path == kGlobal) {
    contingency_global<T><<<grid, threads, 0, s>>>(a, cols);
    return cudaSuccess;
  }
  if (path == kSwar) {
    if constexpr (sizeof(T) == 1) {
      if (vec == 16) return launch_swar<16>(a, cols, grid, threads, smem, s);
      if (vec == 8) return launch_swar<8>(a, cols, grid, threads, smem, s);
    }
    return cudaErrorInvalidValue;
  }
  if (path != kShared) return cudaErrorInvalidValue;
  const int vb = vec * (int)sizeof(T);
  if (vec == 1) return launch_shared_w<T, 1>(a, cols, grid, threads, smem, s);
  if (vb == 16) return launch_shared_w<T, 16 / sizeof(T)>(a, cols, grid, threads, smem, s);
  if constexpr (sizeof(T) <= 4) {
    if (vb == 8) return launch_shared_w<T, 8 / sizeof(T)>(a, cols, grid, threads, smem, s);
  }
  if constexpr (sizeof(T) <= 2) {
    if (vb == 4) return launch_shared_w<T, 4 / sizeof(T)>(a, cols, grid, threads, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype: 0 int8, 1 uint8, 2 int16, 3 int32, 4 int64. Strides in elements.
// `out` holds f * v_count * vc_count int32 counts; it is zeroed here, on the
// stream, ahead of the count. The path and
// its geometry come from kernels/contingency.py::contingency_plan: path 0
// SWAR, 1 shared tables, 2 global atomics; lanes_on_rows 1 for the
// feature-major kernels; vec elements per lane load.
extern "C" int contingency_tables_launch(
    const void* x, int x_dtype, int64_t m, int64_t f, int64_t stride_m, int64_t stride_f,
    const void* y, int v_count, int vc_count, int path, int lanes_on_rows, int vec,
    int threads, int smem_bytes, int64_t rows_per_item, int64_t feat_items, int64_t items,
    int grid, int replicas, void* out, void* stream) {
  const Args a{x, m, f, stride_m, stride_f, static_cast<const int32_t*>(y), v_count,
               vc_count, v_count * vc_count, static_cast<int32_t*>(out), rows_per_item,
               feat_items, items, replicas};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)f * a.cells * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  switch (x_dtype) {
    case 0: e = launch_typed<int8_t>(a, path, lanes_on_rows, vec, grid, threads, smem_bytes, s); break;
    case 1: e = launch_typed<uint8_t>(a, path, lanes_on_rows, vec, grid, threads, smem_bytes, s); break;
    case 2: e = launch_typed<int16_t>(a, path, lanes_on_rows, vec, grid, threads, smem_bytes, s); break;
    case 3: e = launch_typed<int32_t>(a, path, lanes_on_rows, vec, grid, threads, smem_bytes, s); break;
    case 4: e = launch_typed<int64_t>(a, path, lanes_on_rows, vec, grid, threads, smem_bytes, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
