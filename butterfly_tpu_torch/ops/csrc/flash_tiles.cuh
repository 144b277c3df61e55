// Online-softmax tile machinery of the flash kernels' mma.sync and
// CUDA-core routes (flash_attention.cu) and of the ring-attention
// kernel's f32 route (ring_attention.cu), for Hopper (sm_90a); the
// helpers (pack2, mma16816, allow_smem, ...) serve every kernel.
//
// A thread block owns BQ = 64 query rows of one query head and folds key
// tiles of BK = 64 columns into its (running max m, denominator l,
// accumulator) state, kept in registers:
// * fold_tile on the CUDA cores in f32 (256 threads as a 16 x 16 grid,
//   thread (ty, tx) owning rows ty + 16i and columns tx + 16j);
// * fold_tile_mma on the tensor cores for bf16 / f16 (4 warps of 16 rows,
//   mma.sync m16n8k16 for Q.K^T and P.V, the score fragments reused in
//   registers as P.V's A operand; P enters P.V rounded to the input type,
//   the denominator sums the f32 values).
// Which (row, column) pairs are live follows the flash kernels' index
// rule (key c0 + cl lives iff it lies below the tile's `limit` and, when
// causal, at or before its query row); fold_tile also takes the ring
// kernel's position rule, chosen at compile time by POS (kp[cl] <=
// qp[row], the positions staged in shared memory; invalid keys carry
// INT32_MAX, which no real query position reaches). The index rule is
// written out, not wrapped in a functor: nvcc compiled the functor's
// version of the tensor-core fold with more registers, and the fresh
// flash kernel ran slower on an H100.
// Masking contract of every caller: a masked score is the finite -1e30, a
// masked probability exactly 0; key rows at or past the tile's `limit`
// load as zeros, so garbage past it never reaches a product. int8 K/V
// codes widen on the way in (|code| <= 127 is exact in bf16 and f16); the
// K scale multiplies the score column before rsqrt(H), the V scale the
// probability after it entered l.
#pragma once

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace bt {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key columns per tile
constexpr int NT = 256;      // CUDA-core threads: ty = tid / 16, tx = tid % 16
constexpr int NT_MMA = 128;  // tensor-core threads: 4 warps
constexpr int LDP = BK + 4;  // row stride of the probability tile (floats)
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// CUDA cores, f32
// ---------------------------------------------------------------------------

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

template <int H>
__device__ __forceinline__ void init_state(State<H>& st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < H / 16; ++j) st.o[i][j] = 0.f;
  }
}

// Fold one tile of BK key columns, keys c0 .. c0 + BK - 1 of the segment,
// into the state. K then V rows come from kb / vb with row stride
// `rstride`; rows at or past `limit` load as zeros. ksg / vsg are the
// segment's per-key scales (int8 only). Liveness: the index rule with the
// block's first query row q0 (POS false), or the position rule over the
// staged positions qp [BQ] / kp [BK] (POS true). qs holds the block's Q
// tile [BQ][H + 4] in f32.
template <int H, typename KT, bool QUANT, bool POS = false>
__device__ __forceinline__ void fold_tile(
    const float* qs, float* kvs, float* ps, float* ksc, float* vsc,
    const KT* kb, const KT* vb, long long rstride, int c0, int limit,
    const float* ksg, const float* vsg, bool causal, int q0, const int* qp,
    const int* kp, float scale, State<H>& st) {
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
      if constexpr (POS)
        ok[j] = kp[tx + 16 * j] <= qp[ty + 16 * i];
      else
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

// ---------------------------------------------------------------------------
// Tensor cores: bf16 / f16 queries, head dims 16..128. Fragment layouts
// are the PTX ISA's for m16n8k16: lane (g = lane / 4, t = lane % 4) holds
// A rows g and g + 8 at columns 2t, 2t + 1 (+ 8), B column g at rows 2t,
// 2t + 1 (+ 8), C rows g and g + 8 at columns 2t, 2t + 1. Tiles sit in
// shared memory in q's dtype, rows padded by 8 elements so the fragment
// loads of 8 rows x 4 column pairs hit 32 different banks.
// ---------------------------------------------------------------------------

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

template <int H>
__device__ __forceinline__ void init_state(MmaState<H>& st) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = -INFINITY;
    st.l[h] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
}

// The warp's Q fragments from the block's Q tile qs [BQ][H + 8].
template <int H>
__device__ __forceinline__ void load_q_frags(const uint16_t* qs,
                                             uint32_t (&qa)[H / 16][4]) {
  constexpr int LDH = H + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const uint16_t* qr = qs + (warp * 16 + g) * LDH + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * LDH);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * LDH + 8);
  }
}

// Fold one tile of BK key columns into the warp's state (see fold_tile
// for the arguments; the index rule only); qa holds the warp's Q
// fragments, row0 is the warp's first query row.
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

// Dynamic shared memory a kernel needs above the default 48 KB must be
// asked for once per kernel; returns the cudaError_t of that request.
template <typename Kernel>
inline int allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace bt
