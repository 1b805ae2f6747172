// GQA softmax attention on Hopper with an online softmax (flash attention):
//
//   out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h / G, :] * D^-0.5) v[b, j, h / G, :]
//
// q (B, S, H, D), k and v (B, T, KV, D), G = H / KV; float32 or bfloat16
// inputs; scores, softmax and the accumulator in float32; the output in q's
// type, contiguous (B, S, H, D). With `causal`, query i sees keys
// j <= i + T - S (the model's tril(k=T-S) mask); masked scores are -1e30,
// so a row that sees no key averages every V row, as the plain version does.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (body `_kernel`), the prefill attention of every
// layer of the dense decoders (repro_torch.models.attention.attention).
//
// Bound on this card: operations. At B=4, S=T=2048, H=32, KV=4, D=128 the
// causal work is 4*B*H*S^2*D/2 = 1.37e11 flops, 0.139 ms at the 989 TFLOP/s
// of the bf16 tensor cores, against 151 MB of Q, K, V and O, 0.045 ms at
// 3.35 TB/s.
//
// What the design does about it:
//   * One block owns one (b, h, 64-row query tile) and loops over 64-row
//     KV tiles inside the block (the TPU grid's sequential KV axis). The
//     running max, running sum and accumulator stay in registers.
//   * bfloat16 (the serving type): both products on the tensor cores with
//     mma.sync m16n8k16 (bf16 operands, float32 accumulation), four warps
//     of 16 query rows each; P is rounded to bf16 as the operand of P.V and
//     never leaves registers. The scale is applied to the float32 scores
//     (with log2(e), for exp2), since a bf16 operand cannot carry it without
//     rounding. wgmma, TMA and warp specialisation are the next step.
//   * float32 (the tests' type): the products on the CUDA cores in float32
//     (67 TFLOP/s), 256 threads each owning 4 query rows x D/16 columns;
//     Q scaled once after the cast, as the Pallas kernel does, and P written
//     over the K tile in shared memory.
//   * Causal skipping: tiles wholly above the diagonal are never visited,
//     which halves the work at S == T (the Pallas kernel visits and masks
//     them). Query tiles run heaviest first, for balance across the SMs.
//   * GQA through strides: query head h reads KV head h / G in place; the
//     blocks of the G heads of one KV head run next to each other, so K
//     and V tiles come from L2. K and V are never copied up to H heads.
//   * Ragged lengths: query rows past S are zero and never stored; key
//     columns past T score -inf (they add exactly 0), so any S, T >= 1
//     works without padding copies.
//
// Plain C interface, bound with ctypes; the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr float kMasked = -1e30f;
constexpr int kLP = kBKV + 4;  // row stride of P


// Reductions over the 16 lanes that share a query row (one half warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Smem {
  static constexpr int LD = D + 4;  // float4-aligned rows, 4 banks apart
  static constexpr int Q = kBQ * LD;
  static constexpr int K = (kBKV * LD > kBQ * kLP) ? kBKV * LD : kBQ * kLP;
  static constexpr int V = kBKV * D;
  static constexpr size_t bytes = sizeof(float) * (Q + K + V);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int s_len,
                       int t_len, int group, int64_t qsb, int64_t qss, int64_t qsh,
                       int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                       int64_t vss, int64_t vsh, float scale, int causal) {
  using S = Smem<D>;
  constexpr int LD = S::LD;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + S::Q;
  float* Vs = Ks + S::K;
  float* Ps = Ks;  // P overwrites the K tile once the scores are taken

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.z;
  const int heads = gridDim.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[r * LD + d] = (q0 + r < s_len) ? qb[(int64_t)(q0 + r) * qss + d] * scale : 0.f;
  }

  const int offset = t_len - s_len;  // query i sees keys <= i + offset
  int kend = t_len;
  // Skip the tiles above the diagonal, unless some row of this tile sees no
  // key at all (only when S > T): that row averages every key.
  if (causal && q0 + offset >= 0) kend = min(t_len, min(q0 + kBQ, s_len) + offset);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBKV) {
    for (int e = tid; e < kBKV * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < t_len;
      Ks[r * LD + d] = ok ? kb[(int64_t)(k0 + r) * kss + d] : 0.f;
      Vs[r * D + d] = ok ? vb[(int64_t)(k0 + r) * vss + d] : 0.f;
    }
    __syncthreads();  // K, V (and Q on the first tile) in place

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }
    __syncthreads();  // every thread is done with K before P overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= t_len) {
          sc[i][j] = -INFINITY;  // past the end: adds exactly 0
        } else if (causal && kpos > q0 + r + offset) {
          sc[i][j] = kMasked;
        }
        mx = fmaxf(mx, sc[i][j]);
      }
      // Finite: every visited tile holds at least one key below T.
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[r * kLP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();  // P in place

#pragma unroll 2
    for (int c = 0; c < kBKV; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kLP + c]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float* vc = Vs + c * D + tx + 16 * n;
        const float v0 = vc[0], v1 = vc[D], v2 = vc[2 * D], v3 = vc[3 * D];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][n];
          a = fmaf(pv[i].x, v0, a);
          a = fmaf(pv[i].y, v1, a);
          a = fmaf(pv[i].z, v2, a);
          a = fmaf(pv[i].w, v3, a);
          acc[i][n] = a;
        }
      }
    }
    __syncthreads();  // the next tile overwrites K, V and P
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= s_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + (((int64_t)b * s_len + qpos) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) o[tx + 16 * n] = acc[i][n] * inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s, int t,
           int h, int kvh, const int64_t* st, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<D>;
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)h, (unsigned)((s + kBQ - 1) / kBQ), (unsigned)b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, t, h / kvh, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: the two products on the tensor cores (mma.sync m16n8k16,
// bf16 operands, float32 accumulation). Four warps per block, each owning 16
// of the tile's 64 query rows: Q stays in registers as A fragments, the
// scores stay in registers as accumulators and become, rounded to bf16, the
// A fragments of P.V (the accumulator layout of two 8-wide tiles is the A
// layout of one 16-deep step), so P never reaches shared memory. K and V
// tiles are staged in shared memory with 16-byte loads (rows padded by 8
// elements: conflict-free 32-bit reads of K, ldmatrix.trans of V).
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed; lanes 8j..8j+7 give the row addresses
// of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int D>
struct MmaSmem {
  static constexpr int LD = D + 8;  // bf16 row stride: 16-byte rows, 4 banks apart
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kBKV) * LD;
};

// rows x D bf16 tile from global (16-byte aligned rows `stride` elements
// apart, starting at row `r0` of `len`) into shared rows of MmaSmem::LD;
// rows past `len` are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t stride, int r0, int len, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r0 + r < len) x = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * MmaSmem<D>::LD + c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           int s_len, int t_len, int group, int64_t qsb, int64_t qss,
                           int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                           int64_t vss, int64_t vsh, float scale, int causal) {
  constexpr int LD = MmaSmem<D>::LD;
  constexpr int KS = D / 16;  // 16-deep steps over D
  constexpr int NO = D / 8;   // 8-wide output tiles
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBKV * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int h = blockIdx.x, b = blockIdx.z;
  const int heads = gridDim.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const __nv_bfloat16* kb = k + b * ksb + (h / group) * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (h / group) * vsh;

  load_tile<D>(Qs, q + b * qsb + h * qsh, qss, q0, s_len, kBQ);
  __syncthreads();
  uint32_t qa[KS][4];  // this warp's 16 query rows as A fragments
  {
    const __nv_bfloat16* r_lo = Qs + (warp * 16 + g) * LD + 2 * t;
    const __nv_bfloat16* r_hi = r_lo + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(r_lo + 16 * kk);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(r_hi + 16 * kk);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(r_lo + 16 * kk + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(r_hi + 16 * kk + 8);
    }
  }

  const int offset = t_len - s_len;  // query i sees keys <= i + offset
  int kend = t_len;
  if (causal && q0 + offset >= 0) kend = min(t_len, min(q0 + kBQ, s_len) + offset);
  // Scores are kept in log2 units: x = (q . k) * D^-0.5 * log2(e).
  const float scale_log2 = scale * kLog2e;
  const float masked = kMasked;  // the same in either unit once exponentiated
  const int row_lo = q0 + warp * 16 + g;  // this thread's rows: row_lo, row_lo + 8

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial sums, reduced at the end
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBKV) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(Ks, kb, kss, k0, t_len, kBKV);
    load_tile<D>(Vs, vb, vss, k0, t_len, kBKV);
    __syncthreads();

    float sc[kBKV / 8][4];
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        mma_bf16(sc[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr + 16 * kk),
                 *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const int qpos = row_lo + 8 * (e >> 1);
        float x = sc[n][e] * scale_log2;
        if (kpos >= t_len) {
          x = -INFINITY;  // past the end: adds exactly 0
        } else if (causal && kpos > qpos + offset) {
          x = masked;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: the tile holds a key below T
      alpha[r] = exp2f(m[r] - m_new);           // 0 on the first tile (m = -inf)
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t pa[4];
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[half][e] = exp2f(sc[2 * kk + half][e] - m[e >> 1]);
          l[e >> 1] += p[half][e];
        }
      }
      pa[0] = pack_bf16(p[0][0], p[0][1]);  // row g,     keys 2t, 2t+1
      pa[1] = pack_bf16(p[0][2], p[0][3]);  // row g + 8, keys 2t, 2t+1
      pa[2] = pack_bf16(p[1][0], p[1][1]);  // row g,     keys 8+2t, 9+2t
      pa[3] = pack_bf16(p[1][2], p[1][3]);  // row g + 8, keys 8+2t, 9+2t
      // V rows 16kk.. as B fragments: matrix j of ldmatrix holds keys
      // 16kk + 8(j&1).. and columns 16np + 8(j>>1)..
      const int j = lane >> 3, r = lane & 7;
      const __nv_bfloat16* vrow = Vs + (16 * kk + r + 8 * (j & 1)) * LD + 8 * (j >> 1);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, vrow + 16 * np);
        mma_bf16(o[2 * np], pa, vb4[0], vb4[1]);
        mma_bf16(o[2 * np + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row_lo + 8 * r;
    if (qpos >= s_len) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + (((int64_t)b * s_len + qpos) * heads + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int b, int s, int t,
               int h, int kvh, const int64_t* st, float scale, int causal,
               cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<D>;
  const size_t bytes = MmaSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)h, (unsigned)((s + kBQ - 1) / kBQ), (unsigned)b);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s, t, h / kvh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

int launch_mma_d(int d, const void* q, const void* k, const void* v, void* out, int b, int s,
                 int t, int h, int kvh, const int64_t* st, float scale, int causal,
                 cudaStream_t stream) {
  switch (d) {
    case 32: return launch_mma<32>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
    case 64: return launch_mma<64>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
    case 128: return launch_mma<128>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_d(int d, const void* q, const void* k, const void* v, void* out, int b, int s,
             int t, int h, int kvh, const int64_t* st, float scale, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 32: return launch<32>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
    case 64: return launch<64>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
    case 128: return launch<128>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, s, h, d), k and v: (b, t, kvh, d), each contiguous along d, with the
// element strides of their first three axes in `strides` (q's three, then
// k's, then v's). out: contiguous (b, s, h, d) of q's type. bf16 = 0 for
// float32 inputs, 1 for bfloat16 (then every stride a multiple of 8 and
// every pointer 16-byte aligned). d must be 32, 64 or 128; h a multiple of kvh.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int bf16, int b, int s, int t, int h, int kvh, int d,
                                      const void* strides, float scale, int causal,
                                      void* stream) {
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_mma_d(d, q, k, v, out, b, s, t, h, kvh, st, scale, causal, cs);
  return launch_d(d, q, k, v, out, b, s, t, h, kvh, st, scale, causal, cs);
}
