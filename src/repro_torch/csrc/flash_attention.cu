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
//   * bfloat16 (the serving type), warp-specialised wgmma fed by TMA. One
//     block of three warpgroups owns one (b, h, 128-row query tile): two
//     consumer warpgroups of 64 query rows each and one producer warpgroup,
//     which hands its registers to the consumers (setmaxnreg 40 / 232). One
//     producer thread loads the Q tile once and 128-key K and V tiles into a
//     ring in shared memory (3 stages at D=128, 4 at D=32 and 64: what fits
//     in 227 KB), so tiles j+1 and j+2 are in flight while the consumers
//     compute on tile j. Each stage has a "full" barrier (the TMA bytes
//     landed) and an "empty" one (every consumer warp is done with it).
//     S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory
//     through descriptors; the online softmax runs in registers on the
//     accumulator layout, in log2 units; P, rounded to bf16, is the A
//     operand of O += P V from registers (the accumulator layout of two
//     8-key column blocks is the A layout of one 16-key step) and V, read
//     in place, the transposed B operand. The scale is applied to the
//     float32 scores, since a bf16 operand cannot carry it without rounding.
//   * Tiles in shared memory are what TMA writes with the 128-byte swizzle
//     (64-byte at D=32): each row cut into 64-column chunks (32 at D=32),
//     one box each, a chunk's rows SW bytes apart. The wgmma descriptors say
//     the same: K-major Q and K with 8-row groups 8*SW bytes apart, the
//     16-column steps 32 bytes apart inside a chunk; MN-major V with 8-key
//     groups 8*SW bytes apart and chunks 128*SW bytes apart.
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
//   * Ragged lengths: query rows past S are zero (TMA fills outside the
//     tensor with zeros) and never stored; key columns past T score -inf
//     (a zero key would score 0, so the mask stays), so any S, T >= 1
//     works without padding copies.
//   * TMA's rules: a 16-byte-aligned base and strides that are multiples of
//     16 bytes (8 bf16 elements); the wrapper copies a tensor that breaks
//     them (kernels/flash_attention.py, `tma_readable`). The tensor maps
//     are encoded here, per call, from the pointers and element strides;
//     cuTensorMapEncodeTiled comes from the driver through
//     cudaGetDriverEntryPoint, so nothing links libcuda.
//
// Plain C interface, bound with ctypes; the entry returns cudaGetLastError(),
// or kEncodeFailed + the CUresult when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
// bfloat16 inputs: warp-specialised wgmma fed by a TMA ring (see the note at
// the top of the file).
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int kWgBKV = 128;       // keys per KV tile
constexpr int kWgThreads = 384;   // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kSmemMax = 232448;  // shared memory a block may use (227 KB)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = 10000;

template <int D>
struct WgCfg {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle span = a chunk row, bytes
  static constexpr int CW = SW / 2;                      // columns per chunk (one TMA box)
  static constexpr int NCH = D / CW;                     // chunks per row
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;       // descriptor layout: 128B / 64B swizzle
  static constexpr int Q_BYTES = kWgBQ * D * 2;
  static constexpr int KV_BYTES = kWgBKV * D * 2;  // one K or one V tile
  static constexpr int FIT = (kSmemMax - 1024 - 256 - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // 1024 to align the tiles for the swizzle, 256 for the barriers.
  static constexpr size_t bytes = 1024 + Q_BYTES + (size_t)STAGES * 2 * KV_BYTES + 256;
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from reading (or writing) accumulators across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 operands, float32 accumulators d (N/2 per thread).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d += A (64 x 16, registers) * B (16 x 32, MN-major in shared memory:
  // the V tile's rows, N contiguous, read transposed).
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d += A (64 x 16, registers) * B (16 x 64, MN-major in shared memory:
  // the V tile's rows, N contiguous, read transposed).
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A (64 x 16, K-major in shared memory) * B (16 x 128, K-major in
  // shared memory: the K tile's rows); scale_d == 0 overwrites d.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A (64 x 16, registers) * B (16 x 128, MN-major in shared memory:
  // the V tile's rows, N contiguous, read transposed).
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ out, int s_len, int t_len, int group,
                             float scale, int causal) {
  using C = WgCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + C::Q_BYTES;  // stage st: K at ring + 2*st*KV_BYTES, then V
  const uint32_t bars = ring + C::STAGES * 2 * C::KV_BYTES;
  auto full_bar = [&](int st) { return bars + 8u * st; };
  auto empty_bar = [&](int st) { return bars + 8u * (C::STAGES + st); };
  const uint32_t q_bar = bars + 16u * C::STAGES;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;  // heaviest tiles first
  const int offset = t_len - s_len;                      // query i sees keys <= i + offset
  int kend = t_len;
  // Skip the tiles above the diagonal, unless some row of this tile sees no
  // key at all (only when S > T): that row averages every key.
  if (causal && q0 + offset >= 0) kend = min(t_len, min(q0 + kWgBQ, s_len) + offset);
  const int ntiles = (kend + kWgBKV - 1) / kWgBKV;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), 8);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread issues every load; the warpgroup's registers go
    // to the consumers.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int kvh = h / group;
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(q_s + c * kWgBQ * C::SW, &qmap, q_bar, c * C::CW, h, q0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % C::STAGES;
        mbar_wait(empty_bar(st), ((j / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar(st), 2 * C::KV_BYTES);
        const uint32_t k_s = ring + 2 * st * C::KV_BYTES, v_s = k_s + C::KV_BYTES;
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(k_s + c * kWgBKV * C::SW, &kmap, full_bar(st), c * C::CW, kvh,
                      j * kWgBKV, b);
          tma_load_4d(v_s + c * kWgBKV * C::SW, &vmap, full_bar(st), c * C::CW, kvh,
                      j * kWgBKV, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; warp w of
    // it rows 16 w .. + 15, this thread rows row_lo and row_lo + 8.
    setmaxnreg_inc<232>();
    constexpr int NS = kWgBKV / 2;  // score accumulators per thread
    constexpr int NO = D / 2;       // output accumulators per thread
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row_lo = q0 + wg * 64 + warp * 16 + g;
    // Scores are kept in log2 units: x = (q . k) * D^-0.5 * log2(e).
    const float scale_log2 = scale * kLog2e;
    const uint32_t qa = q_s + wg * 64 * C::SW;  // this warpgroup's rows in each chunk

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's partial sums, reduced at the end
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;

    mbar_wait(q_bar, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % C::STAGES;
      const uint32_t k_s = ring + 2 * st * C::KV_BYTES, v_s = k_s + C::KV_BYTES;
      mbar_wait(full_bar(st), (j / C::STAGES) & 1);

      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk * 16 / C::CW) * kWgBQ * C::SW + (kk * 16 % C::CW) * 2;
        const uint32_t bt = (kk * 16 / C::CW) * kWgBKV * C::SW + (kk * 16 % C::CW) * 2;
        Wgmma<kWgBKV>::ss(sc, smem_desc(qa + at, 16, 8 * C::SW, C::LAYOUT),
                          smem_desc(k_s + bt, 16, 8 * C::SW, C::LAYOUT), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // sc[4n + e]: key k0 + 8n + 2t + (e & 1), query row row_lo + 8 (e >> 1).
      const int k0 = j * kWgBKV;
      const bool edge = k0 + kWgBKV > t_len ||
                        (causal && k0 + kWgBKV - 1 > q0 + wg * 64 + offset);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS / 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e] * scale_log2;
          if (edge) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = row_lo + 8 * (e >> 1);
            if (kpos >= t_len) {
              x = -INFINITY;  // past the end: adds exactly 0
            } else if (causal && kpos > qpos + offset) {
              x = kMasked;
            }
          }
          sc[4 * n + e] = x;
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
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];

      uint32_t pa[kWgBKV / 16][4];  // P as the A operand, one 16-key step each
#pragma unroll
      for (int kk = 0; kk < kWgBKV / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = exp2f(sc[8 * kk + e] - m[(e >> 1) & 1]);
          l[(e >> 1) & 1] += p[e];
        }
        pa[kk][0] = pack_bf16(p[0], p[1]);  // row g,     keys 2t, 2t+1
        pa[kk][1] = pack_bf16(p[2], p[3]);  // row g + 8, keys 2t, 2t+1
        pa[kk][2] = pack_bf16(p[4], p[5]);  // row g,     keys 8+2t, 9+2t
        pa[kk][3] = pack_bf16(p[6], p[7]);  // row g + 8, keys 8+2t, 9+2t
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBKV / 16; ++kk) {
        Wgmma<D>::rs(o, pa[kk],
                     smem_desc(v_s + kk * 16 * C::SW, kWgBKV * C::SW, 8 * C::SW, C::LAYOUT));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));  // this warp is done with the stage
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
      __nv_bfloat16* orow = out + (((int64_t)b * s_len + qpos) * gridDim.x + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(orow + 8 * n) =
            pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (batch, len, heads, D) bf16 tensor with element strides (sb, sl, sh)
// and a contiguous last axis, as a 4-D map (D, heads, len, batch) whose box
// is one chunk of `rows` rows of one head: (CW, 1, rows, 1).
template <int D>
int encode(CUtensorMap* map, const void* ptr, int batch, int len, int heads, int64_t sb,
           int64_t sl, int64_t sh, int rows) {
  using C = WgCfg<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)len,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int s, int t,
                 int h, int kvh, const int64_t* st, float scale, int causal,
                 cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int err = encode<D>(&qmap, q, b, s, h, st[0], st[1], st[2], kWgBQ);
  if (err == 0) err = encode<D>(&kmap, k, b, t, kvh, st[3], st[4], st[5], kWgBKV);
  if (err == 0) err = encode<D>(&vmap, v, b, t, kvh, st[6], st[7], st[8], kWgBKV);
  if (err != 0) return err;
  auto kernel = flash_attention_wgmma_kernel<D>;
  const size_t bytes = WgCfg<D>::bytes;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid((unsigned)h, (unsigned)((s + kWgBQ - 1) / kWgBQ), (unsigned)b);
  kernel<<<grid, kWgThreads, bytes, stream>>>(qmap, kmap, vmap,
                                               static_cast<__nv_bfloat16*>(out), s, t, h / kvh,
                                               scale, causal);
  return (int)cudaGetLastError();
}

int launch_wgmma_d(int d, const void* q, const void* k, const void* v, void* out, int b, int s,
                   int t, int h, int kvh, const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  switch (d) {
    case 32: return launch_wgmma<32>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
    case 64: return launch_wgmma<64>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
    case 128: return launch_wgmma<128>(q, k, v, out, b, s, t, h, kvh, st, scale, causal, stream);
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
// float32 inputs, 1 for bfloat16 (then, for TMA, every pointer 16-byte
// aligned and every stride a positive multiple of 8). d must be 32, 64 or
// 128; h a multiple of kvh.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int bf16, int b, int s, int t, int h, int kvh, int d,
                                      const void* strides, float scale, int causal,
                                      void* stream) {
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_wgmma_d(d, q, k, v, out, b, s, t, h, kvh, st, scale, causal, cs);
  return launch_d(d, q, k, v, out, b, s, t, h, kvh, st, scale, causal, cs);
}
