// Flash prefill attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces two Pallas TPU kernels of butterfly_tpu/ops/flash_attention.py:
// * bt_flash_fresh replaces _flash_kernel (flash_attention.py:66, its
//   pallas_call at :367): blockwise causal or non-causal self-attention
//   over the freshly projected Q/K/V of a prefill;
// * bt_flash_warm replaces _flash_warm_kernel (flash_attention.py:97, its
//   pallas_call at :469): a chunk continuation, where ONE online-softmax
//   state runs first over the cached prefix (columns below prefix_len[b],
//   no causal triangle; a float view or int8 codes + f32 scales) and then
//   over the causal fresh chunk.
//
// What bounds it on this card: at Llama-3-8B shapes a T = 1024 causal
// prefill does ~400 flops per byte of Q/K/V/O it must move, above the
// ~295 where the tensor cores and not HBM become the limit, so it is bound
// by operations. A 512-token warm chunk (B = 4) is bound by bytes while
// its live prefix is short — under ~500 rows across the batch — and by
// operations past that, since each live prefix row costs 512 queries'
// work for 4 KB read.
//
// Design, for the card rather than carried over from the Pallas grid:
// * one thread block per (tile of BQ = 64 query rows, query head, batch
//   row); query head n reads kv head n / (Nq / Kv). The Pallas grid's
//   sequential reduction axis becomes a loop inside the block over tiles
//   of BK = 64 key columns, with the online-softmax state (running max m,
//   denominator l, accumulator) in registers.
// * bf16 / f16 at head dims up to 128 (the main path: Llama-3-8B H = 128,
//   GPT-2 H = 64) run on the tensor cores: 4 warps of 16 query rows each,
//   Q.K^T and P.V as mma.sync m16n8k16 with f32 accumulation, the score
//   fragments reused in registers as P.V's A operand. The TPU kernel
//   keeps the probabilities in f32 for P.V; here they enter P.V rounded
//   to q's dtype (bf16: relative error <= 2^-8), while the denominator
//   sums the f32 values. That moves an output by at most 2^-8 of
//   sum_j p_j |v_j| / l, which chip_smoke.py holds every element to.
//   See flash_mma_kernel.
// * f32, and H = 256, run on the CUDA cores in f32 (flash_kernel): 256
//   threads as a 16 x 16 grid, thread (ty, tx) owning query rows ty + 16i
//   (i < 4), score columns tx + 16j (j < 4) of each 64 x 64 score tile
//   and output columns tx + 16j (j < H/16); the Q tile in shared memory,
//   K then V through one f32 buffer (rows padded by 4 floats, so 16-byte
//   reads of 16 rows hit different banks), probabilities through a 64 x 64
//   tile. Nothing is rounded before the output.
// * the float prefix is read in its own layout through strides (batch,
//   sequence, head), so the gathered pool view needs no kv-major copy;
//   int8 codes [B, Kv, Sp, H] are read through the same strides and their
//   K scale multiplies the score columns before rsqrt(H), the V scale
//   multiplies the probabilities after they enter the denominator, as on
//   the TPU. Prefix tiles stop at prefix_len[b]: work past it is skipped.
// * masking contract: a masked score is the finite -1e30, a masked
//   probability is exactly 0, the output is acc / max(l, 1e-30). Key rows
//   past a segment's limit load as zeros, so garbage past prefix_len
//   never reaches a product.
// Not yet done (a later change): wgmma on 64-row warpgroup tiles, TMA /
// cp.async pipelining of the K/V tiles, one block per kv head serving its
// query group, reading the pool's pages through the block table.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key columns per tile
constexpr int NT = 256;      // threads per block: ty = tid / 16, tx = tid % 16
constexpr int LDP = BK + 4;  // row stride of the probability tile (floats)
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

// four consecutive elements as floats (16, 8 or 4 bytes, aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// ROWS rows of H elements into dst [ROWS][H + 4] as floats: row r is
// base[(r0 + r) * rstride ...]; rows at or past `limit` become zeros.
template <int H, int ROWS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long rstride, int r0,
                                          int limit) {
  constexpr int LD = H + 4;
  constexpr int C4 = H / 4;
  for (int e = threadIdx.x; e < ROWS * C4; e += NT) {
    const int r = e / C4;
    const int c = (e - r * C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit)
      x = load4(base + static_cast<long long>(r0 + r) * rstride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// A thread's share of the online-softmax state: 4 query rows.
template <int H>
struct State {
  float o[4][H / 16];  // accumulator, columns tx + 16j
  float m[4];          // running max
  float l[4];          // running denominator
};

// Fold one tile of BK key columns into the state. Column c is key c0 + c
// of its segment, live iff c0 + c < limit and, when causal, c0 + c <= the
// query row. K then V rows come from kb / vb with row stride `rstride`;
// ksg / vsg are the segment's per-key scales (int8 prefix only).
template <int H, typename KT, bool QUANT>
__device__ __forceinline__ void fold_tile(
    const float* qs, float* kvs, float* ps, float* ksc, float* vsc,
    const KT* kb, const KT* vb, long long rstride, int c0, int limit,
    const float* ksg, const float* vsg, bool causal, int q0, float scale,
    State<H>& st) {
  constexpr int LD = H + 4;
  constexpr int NJ = H / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows<H, BK>(kvs, kb, rstride, c0, limit);
  if constexpr (QUANT) {
    for (int c = threadIdx.x; c < BK; c += NT) {
      const bool ok = c0 + c < limit;
      ksc[c] = ok ? ksg[c0 + c] : 0.f;
      vsc[c] = ok ? vsg[c0 + c] : 0.f;
    }
  }
  __syncthreads();  // Q (first tile), K tile and scales staged

  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < H; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    bool ok[4];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      ok[j] = c < limit && (!causal || c <= row);
      float x = s[i][j];
      if constexpr (QUANT) x *= ksc[tx + 16 * j];  // K scale, then rsqrt(H)
      s[i][j] = ok[j] ? x * scale : NEG;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(st.m[i], mx);
    const float corr = expf(st.m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      sum += p;
      // the V scale folds into the probability after it entered l
      ps[(ty + 16 * i) * LDP + tx + 16 * j] =
          QUANT ? p * vsc[tx + 16 * j] : p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    st.l[i] = st.l[i] * corr + sum;
    st.m[i] = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) st.o[i][j] *= corr;
  }
  __syncthreads();  // K tile consumed, probabilities written

  load_rows<H, BK>(kvs, vb, rstride, c0, limit);
  __syncthreads();  // V tile staged
#pragma unroll 2
  for (int c = 0; c < BK; c += 4) {
    float4 p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p4[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * LDP + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* vr = kvs + c * LD + tx + 16 * j;
      const float v0 = vr[0], v1 = vr[LD], v2 = vr[2 * LD], v3 = vr[3 * LD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = st.o[i][j];
        x = fmaf(p4[i].x, v0, x);
        x = fmaf(p4[i].y, v1, x);
        x = fmaf(p4[i].z, v2, x);
        x = fmaf(p4[i].w, v3, x);
        st.o[i][j] = x;
      }
    }
  }
  __syncthreads();  // V tile and probabilities consumed
}

struct Args {
  const void* q;     // [B, T, Nq, H]
  const void* k;     // [B, T, Kv, H]
  const void* v;
  void* out;         // [B, T, Nq, H]
  const void* pk;    // warm prefix, rows (b, c, kv) at b*psb + c*pss + kv*psh
  const void* pv;
  const float* pks;  // [B, Kv, Sp] iff the prefix is int8
  const float* pvs;
  const int* plen;   // [B]
  long long psb, pss, psh;
  int T, Nq, Kv, Sp, causal;
};

template <typename T, typename PT, int H, bool WARM, bool QUANT>
__global__ void __launch_bounds__(NT) flash_kernel(Args a) {
  constexpr int LD = H + 4;
  constexpr int NJ = H / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* kvs = qs + BQ * LD;                    // [BK][LD], K then V
  float* ps = kvs + BK * LD;                    // [BQ][LDP]
  float* ksc = ps + BQ * LDP;                   // [BK] (int8 prefix)
  float* vsc = ksc + BK;                        // [BK]
  const int q0 = blockIdx.x * BQ, n = blockIdx.y, b = blockIdx.z;
  const int kv = n / (a.Nq / a.Kv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long qstride = static_cast<long long>(a.Nq) * H;
  const long long kstride = static_cast<long long>(a.Kv) * H;
  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<long long>(b) * a.T * a.Nq + n) * H;
  load_rows<H, BQ>(qs, qb, qstride, q0, a.T);

  State<H> st;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) st.o[i][j] = 0.f;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(H));

  if constexpr (WARM) {
    int plen = a.plen[b];
    plen = plen < 0 ? 0 : (plen > a.Sp ? a.Sp : plen);
    const long long off = static_cast<long long>(b) * a.psb +
                          static_cast<long long>(kv) * a.psh;
    const PT* pkb = static_cast<const PT*>(a.pk) + off;
    const PT* pvb = static_cast<const PT*>(a.pv) + off;
    const float* ksg = nullptr;
    const float* vsg = nullptr;
    if constexpr (QUANT) {
      const long long srow = (static_cast<long long>(b) * a.Kv + kv) * a.Sp;
      ksg = a.pks + srow;
      vsg = a.pvs + srow;
    }
    for (int c0 = 0; c0 < plen; c0 += BK)
      fold_tile<H, PT, QUANT>(qs, kvs, ps, ksc, vsc, pkb, pvb, a.pss, c0,
                              plen, ksg, vsg, false, q0, scale, st);
  }
  // fresh chunk: positions relative to the chunk (a warm chunk's queries
  // and keys share the row's prefix offset, so the triangle is exact)
  const bool causal = WARM || a.causal != 0;
  const int kend = causal ? min(a.T, q0 + BQ) : a.T;
  const long long koff = static_cast<long long>(b) * a.T * a.Kv + kv;
  const T* kb = static_cast<const T*>(a.k) + koff * H;
  const T* vb = static_cast<const T*>(a.v) + koff * H;
  for (int c0 = 0; c0 < kend; c0 += BK)
    fold_tile<H, T, false>(qs, kvs, ps, ksc, vsc, kb, vb, kstride, c0, a.T,
                           nullptr, nullptr, causal, q0, scale, st);

  T* ob = static_cast<T*>(a.out) +
          (static_cast<long long>(b) * a.T * a.Nq + n) * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < a.T) {
      const float den = fmaxf(st.l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ob[row * qstride + tx + 16 * j] = from_f<T>(st.o[i][j] / den);
    }
  }
}

template <typename T, typename PT, int H, bool WARM, bool QUANT>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int LD = H + 4;
  const size_t bytes =
      (static_cast<size_t>(BQ + BK) * LD + BQ * LDP + 2 * BK) * sizeof(float);
  auto kern = flash_kernel<T, PT, H, WARM, QUANT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.T + BQ - 1) / BQ, a.Nq, B);
  kern<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 / f16 queries, head dims 16..128 (see the note
// at the top). Fragment layouts are the PTX ISA's for m16n8k16: lane
// (g = lane / 4, t = lane % 4) holds A rows g and g + 8 at columns 2t,
// 2t + 1 (+ 8), B column g at rows 2t, 2t + 1 (+ 8), C rows g and g + 8
// at columns 2t, 2t + 1. Tiles sit in shared memory in q's dtype, rows
// padded by 8 elements so the fragment loads of 8 rows x 4 column pairs
// hit 32 different banks; int8 prefix codes are widened on the way in
// (|code| <= 127 is exact in bf16 and f16).
// ---------------------------------------------------------------------------

constexpr int NT_MMA = 128;  // 4 warps

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one 32-bit pair of T (x in the low half)
template <typename T> __device__ __forceinline__ uint32_t pack2(float x,
                                                                float y);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 8 consecutive elements as 16 bytes of T (int8 codes widened)
template <typename T>
__device__ __forceinline__ uint4 load8(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <typename T>
__device__ __forceinline__ uint4 load8(const int8_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
  uint4 r;
  r.x = pack2<T>(c[0], c[1]);
  r.y = pack2<T>(c[2], c[3]);
  r.z = pack2<T>(c[4], c[5]);
  r.w = pack2<T>(c[6], c[7]);
  return r;
}

// ROWS rows of H elements into dst [ROWS][H + 8] (T bits); rows at or
// past `limit` become zeros.
template <typename T, int H, int ROWS, typename ST>
__device__ __forceinline__ void load_rows_t(uint16_t* dst, const ST* base,
                                            long long rstride, int r0,
                                            int limit) {
  constexpr int LDH = H + 8;
  constexpr int C8 = H / 8;
  for (int e = threadIdx.x; e < ROWS * C8; e += NT_MMA) {
    const int r = e / C8;
    const int c = (e - r * C8) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      x = load8<T>(base + static_cast<long long>(r0 + r) * rstride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = x;
  }
}

template <int H>
struct MmaState {
  float o[H / 8][4];  // accumulator fragments, head-dim tiles of 8
  float m[2];         // running max of rows g and g + 8
  float l[2];         // running denominators
};

// Fold one tile of BK key columns (see fold_tile for the masking rule)
// into the warp's state; qa holds the warp's Q fragments.
template <typename T, int H, typename KT, bool QUANT>
__device__ __forceinline__ void fold_tile_mma(
    const uint32_t (&qa)[H / 16][4], uint16_t* ks, uint16_t* vs, float* ksc,
    float* vsc, const KT* kb, const KT* vb, long long rstride, int c0,
    int limit, const float* ksg, const float* vsg, bool causal, int row0,
    float scale, MmaState<H>& st) {
  constexpr int LDH = H + 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  load_rows_t<T, H, BK>(ks, kb, rstride, c0, limit);
  load_rows_t<T, H, BK>(vs, vb, rstride, c0, limit);
  if constexpr (QUANT) {
    for (int c = threadIdx.x; c < BK; c += NT_MMA) {
      const bool ok = c0 + c < limit;
      ksc[c] = ok ? ksg[c0 + c] : 0.f;
      vsc[c] = ok ? vsg[c0 + c] : 0.f;
    }
  }
  __syncthreads();  // Q (first tile), K, V and scales staged

  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint16_t* kr = ks + (j * 8 + g) * LDH + kk * 16 + t * 2;
      mma16816<T>(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows g and g + 8
    const int row = row0 + g + 8 * h;
    bool ok[BK / 8][2];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = j * 8 + t * 2 + e;
        const int c = c0 + cl;
        ok[j][e] = c < limit && (!causal || c <= row);
        float x = s[j][2 * h + e];
        if constexpr (QUANT) x *= ksc[cl];  // K scale, then rsqrt(H)
        x = ok[j][e] ? x * scale : NEG;
        s[j][2 * h + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(st.m[h], mx);
    const float corr = expf(st.m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[j][e] ? expf(s[j][2 * h + e] - m_new) : 0.f;
        sum += p;
        // the V scale folds into the probability after it entered l
        s[j][2 * h + e] = QUANT ? p * vsc[j * 8 + t * 2 + e] : p;
      }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    st.l[h] = st.l[h] * corr + sum;
    st.m[h] = m_new;
#pragma unroll
    for (int n = 0; n < H / 8; ++n) {
      st.o[n][2 * h] *= corr;
      st.o[n][2 * h + 1] *= corr;
    }
  }

  // P.V: the score fragments of key tiles 2kk, 2kk + 1, rounded to T,
  // are the A fragment of keys kk*16 .. kk*16 + 15 (l above summed the
  // unrounded f32 values).
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                            pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                            pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < H / 8; ++n) {
      const uint16_t* vr = vs + (kk * 16 + t * 2) * LDH + n * 8 + g;
      const uint32_t b0 = static_cast<uint32_t>(vr[0]) |
                          (static_cast<uint32_t>(vr[LDH]) << 16);
      const uint32_t b1 = static_cast<uint32_t>(vr[8 * LDH]) |
                          (static_cast<uint32_t>(vr[9 * LDH]) << 16);
      mma16816<T>(st.o[n], pa, b0, b1);
    }
  }
  __syncthreads();  // K and V tiles consumed
}

template <typename T, typename PT, int H, bool WARM, bool QUANT>
__global__ void __launch_bounds__(NT_MMA) flash_mma_kernel(Args a) {
  constexpr int LDH = H + 8;
  extern __shared__ uint4 smem16[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem16);  // [BQ][LDH]
  uint16_t* ks = qs + BQ * LDH;                         // [BK][LDH]
  uint16_t* vs = ks + BK * LDH;                         // [BK][LDH]
  float* ksc = reinterpret_cast<float*>(vs + BK * LDH); // [BK] (int8)
  float* vsc = ksc + BK;
  const int q0 = blockIdx.x * BQ, n = blockIdx.y, b = blockIdx.z;
  const int kv = n / (a.Nq / a.Kv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // this warp's first query row
  const long long qstride = static_cast<long long>(a.Nq) * H;
  const long long kstride = static_cast<long long>(a.Kv) * H;
  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<long long>(b) * a.T * a.Nq + n) * H;
  load_rows_t<T, H, BQ>(qs, qb, qstride, q0, a.T);
  __syncthreads();
  uint32_t qa[H / 16][4];
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const uint16_t* qr = qs + (warp * 16 + g) * LDH + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * LDH);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * LDH + 8);
  }

  MmaState<H> st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = -INFINITY;
    st.l[h] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
  const float scale = 1.0f / sqrtf(static_cast<float>(H));

  if constexpr (WARM) {
    int plen = a.plen[b];
    plen = plen < 0 ? 0 : (plen > a.Sp ? a.Sp : plen);
    const long long off = static_cast<long long>(b) * a.psb +
                          static_cast<long long>(kv) * a.psh;
    const PT* pkb = static_cast<const PT*>(a.pk) + off;
    const PT* pvb = static_cast<const PT*>(a.pv) + off;
    const float* ksg = nullptr;
    const float* vsg = nullptr;
    if constexpr (QUANT) {
      const long long srow = (static_cast<long long>(b) * a.Kv + kv) * a.Sp;
      ksg = a.pks + srow;
      vsg = a.pvs + srow;
    }
    for (int c0 = 0; c0 < plen; c0 += BK)
      fold_tile_mma<T, H, PT, QUANT>(qa, ks, vs, ksc, vsc, pkb, pvb, a.pss,
                                     c0, plen, ksg, vsg, false, row0, scale,
                                     st);
  }
  const bool causal = WARM || a.causal != 0;
  const int kend = causal ? min(a.T, q0 + BQ) : a.T;
  const long long koff = static_cast<long long>(b) * a.T * a.Kv + kv;
  const T* kb = static_cast<const T*>(a.k) + koff * H;
  const T* vb = static_cast<const T*>(a.v) + koff * H;
  for (int c0 = 0; c0 < kend; c0 += BK)
    fold_tile_mma<T, H, T, false>(qa, ks, vs, ksc, vsc, kb, vb, kstride, c0,
                                  a.T, nullptr, nullptr, causal, row0, scale,
                                  st);

  T* ob = static_cast<T*>(a.out) +
          (static_cast<long long>(b) * a.T * a.Nq + n) * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < a.T) {
      const float den = fmaxf(st.l[h], 1e-30f);
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + row * qstride + j * 8 + t * 2) =
            pack2<T>(st.o[j][2 * h] / den, st.o[j][2 * h + 1] / den);
    }
  }
}

template <typename T, typename PT, int H, bool WARM, bool QUANT>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  constexpr int LDH = H + 8;
  const size_t bytes = static_cast<size_t>(BQ + 2 * BK) * LDH *
                           sizeof(uint16_t) + 2 * BK * sizeof(float);
  auto kern = flash_mma_kernel<T, PT, H, WARM, QUANT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.T + BQ - 1) / BQ, a.Nq, B);
  kern<<<grid, NT_MMA, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// f32 takes the CUDA-core kernel at every head dim; bf16 and f16 take the
// tensor-core kernel up to H = 128 (at H = 256 its accumulators alone
// would need 128 registers a thread) and the CUDA-core one above.
template <typename T, typename PT, bool WARM, bool QUANT>
int launch_h(const Args& a, int B, int H, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (H) {
      case 16: return launch<T, PT, 16, WARM, QUANT>(a, B, s);
      case 32: return launch<T, PT, 32, WARM, QUANT>(a, B, s);
      case 64: return launch<T, PT, 64, WARM, QUANT>(a, B, s);
      case 128: return launch<T, PT, 128, WARM, QUANT>(a, B, s);
      case 256: return launch<T, PT, 256, WARM, QUANT>(a, B, s);
      default: return -1;
    }
  } else {
    switch (H) {
      case 16: return launch_mma<T, PT, 16, WARM, QUANT>(a, B, s);
      case 32: return launch_mma<T, PT, 32, WARM, QUANT>(a, B, s);
      case 64: return launch_mma<T, PT, 64, WARM, QUANT>(a, B, s);
      case 128: return launch_mma<T, PT, 128, WARM, QUANT>(a, B, s);
      case 256: return launch<T, PT, 256, WARM, QUANT>(a, B, s);
      default: return -1;
    }
  }
}

template <typename T>
int launch_t(const Args& a, bool warm, bool quant, int B, int H,
             cudaStream_t s) {
  if (!warm) return launch_h<T, T, false, false>(a, B, H, s);
  if (quant) return launch_h<T, int8_t, true, true>(a, B, H, s);
  return launch_h<T, T, true, false>(a, B, H, s);
}

int dispatch(int dtype, const Args& a, bool warm, bool quant, int B, int H,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<float>(a, warm, quant, B, H, s);
    case 1: return launch_t<__half>(a, warm, quant, B, H, s);
    case 2: return launch_t<__nv_bfloat16>(a, warm, quant, B, H, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v and out). All
// of q/k/v/out contiguous [B, T, N, H]. Returns 0 on success, -1 for an
// unsupported dtype or head_dim, else the cudaError_t of the launch.
extern "C" int bt_flash_fresh(int dtype, const void* q, const void* k,
                              const void* v, void* out, int B, int T,
                              int Nq, int Kv, int H, int causal,
                              void* stream) {
  const Args a{q, k, v, out, nullptr, nullptr, nullptr, nullptr, nullptr,
               0, 0, 0, T, Nq, Kv, 0, causal};
  return dispatch(dtype, a, false, false, B, H, stream);
}

// The warm chunk (always causal): as bt_flash_fresh, plus a prefix of Sp
// rows per (batch row, kv head) at element offsets b*psb + c*pss + kv*psh
// (last dim contiguous): in q's dtype when quant == 0, else int8 codes
// with f32 scales pks / pvs [B, Kv, Sp]; plen [B] live prefix rows.
extern "C" int bt_flash_warm(int dtype, int quant, const void* q,
                             const void* k, const void* v, const void* pk,
                             const void* pv, const float* pks,
                             const float* pvs, const int* plen, void* out,
                             int B, int T, int Nq, int Kv, int H, int Sp,
                             long long psb, long long pss, long long psh,
                             void* stream) {
  const Args a{q, k, v, out, pk, pv, pks, pvs, plen,
               psb, pss, psh, T, Nq, Kv, Sp, 1};
  return dispatch(dtype, a, true, quant != 0, B, H, stream);
}
