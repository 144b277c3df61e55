// Paged decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces butterfly_tpu/ops/paged_attention.py:_paged_kernel (the Pallas
// TPU kernel): one decode token of attention per slot over the paged KV
// pool, walking the slot's block table over the pages below lengths[s]
// with an online softmax, plus an optional write-combined window segment
// of win_count[s] staged tokens folded into the same softmax.
//
// What bounds it on this card: HBM bytes. A decode step does ~2 flops per
// K/V byte it reads, far below the ~295 flops/byte where the tensor cores
// would become the limit, so the levers are to read the live K/V once, to
// spread it over every SM and to keep many loads in flight.
//
// Design (split-KV, "flash-decoding"):
// * grid (n_split, Kv, S). Split i < n_page_splits folds the tokens
//   [i * split_pages * page, (i + 1) * split_pages * page) below lengths[s]
//   of kv head kv into a partial (m, l, acc) for the G = Nq / Kv query
//   heads of the group; the last split (when there is a window) folds the
//   win_count[s] window tokens. n_split comes from the table's width and
//   the static split size (ops/paged_attention.py:split_plan), never from
//   lengths, so the launch reads nothing on the host and has a fixed
//   shape. A split that starts at or past its segment's length writes the
//   empty partial m = -1e30, l = 0, acc = 0 and returns.
// * a second kernel (paged_merge_kernel) merges each slot's partials in
//   split order: M = max m_i, out = sum acc_i 2^(m_i - M) /
//   max(sum l_i 2^(m_i - M), 1e-30). No atomics: the output is the same
//   bits from run to run.
// * bf16 / f16 queries with G <= 8 (paged_tc_kernel): each of 4 warps
//   streams its own 16-token chunks of the split through a ring of 3
//   warp-private shared-memory stages with cp.async (16 bytes a lane; rows
//   past the length are zero-filled, not read), so two chunks are in
//   flight while one is folded, with no block barrier in the loop. Scores
//   and P.V run on the tensor cores as mma.sync m16n8k16: Q.K^T with the
//   chunk's 16 tokens on M (K fragments by ldmatrix) and the G query heads
//   on N (Q fragments in registers for the whole block); P is rounded to
//   q's dtype, moved from the score layout to the B layout in registers
//   (movmatrix.trans) and multiplies V^T (fragments by ldmatrix.trans from
//   the row-major [token][h] tile), so G is N again. Softmax in base 2:
//   log2(e) / sqrt(H) is one factor on the scores, exp2f does the rest;
//   the denominator is summed per lane and reduced once at the end.
// * int8 pools: the codes arrive by cp.async and widen to q's dtype
//   (exact for |code| <= 127) into a warp-private tile on the way from
//   shared memory to the fragments. The K scale multiplies the score and
//   the V scale the probability after it entered l, as on the TPU.
// * f32 queries, or G > 8 (paged_cc_kernel): the CUDA-core fold of the
//   first design (each warp an online softmax over strided 4-8-token
//   chunks, lanes holding H/32-element slices, shuffle-reduced dots), but
//   under the same split grid and merge.
// * masking contract: a masked score is the finite -1e30, a masked
//   probability is exactly 0, the output is acc / max(l, 1e-30), and a
//   slot with nothing to attend returns zeros.
// Not yet done (a later change): TMA page copies, one persistent block per
// SM walking splits, the merge inside the last split's block.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int CC_WARPS = 8;   // CUDA-core kernel: warps per block
constexpr int TC_WARPS = 4;   // tensor-core kernel: warps per block
constexpr int CH = 16;        // tensor-core kernel: tokens per chunk
constexpr int STAGES = 3;     // tensor-core kernel: chunks per warp ring

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
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

struct Args {
  const void* q;          // [S, Nq, H]
  const void* k_pages;    // [P, Kv, page, H]
  const void* v_pages;
  const float* k_scale;   // [P, Kv*page] or null
  const float* v_scale;
  const int* table;       // [S, max_pages]
  const int* lengths;     // [S]
  const void* win_k;      // [S, Kv, W, H] or null
  const void* win_v;
  const float* win_k_scale;  // [S, Kv, W] or null
  const float* win_v_scale;
  const int* win_count;   // [S] or null
  void* out;              // [S, Nq, H]
  float* ws;              // partials: acc [S, Kv, n_split, G, H], then m, l
                          // [S, Kv, n_split, G] each
  int Nq, Kv, page, max_pages, W;
  int split_pages, n_page_splits, n_split;
};

// The block's segment: tokens [t0, t1) of the paged run or of the window.
struct Seg {
  int t0, t1;
  bool win;
};

__device__ __forceinline__ Seg block_segment(const Args& a, int sp, int s) {
  Seg g;
  g.win = a.win_k != nullptr && sp == a.n_page_splits;
  if (g.win) {
    int wc = a.win_count[s];
    g.t0 = 0;
    g.t1 = wc < 0 ? 0 : (wc > a.W ? a.W : wc);
  } else {
    int len = a.lengths[s];
    const int cap = a.max_pages * a.page;
    len = len < 0 ? 0 : (len > cap ? cap : len);
    const int span = a.split_pages * a.page;
    g.t0 = sp * span;
    g.t1 = min(g.t0 + span, len);
  }
  return g;
}

// Element row of token n of the segment in its K/V array (times H gives
// the element offset) and the index of its int8 scale.
__device__ __forceinline__ void token_row(const Args& a, const Seg& g, int s,
                                          int kv, int n, long long& row,
                                          long long& sc) {
  if (g.win) {
    row = (static_cast<long long>(s) * a.Kv + kv) * a.W + n;
    sc = row;
  } else {
    const int j = n / a.page, off = n - j * a.page;
    const long long pid = a.table[static_cast<long long>(s) * a.max_pages + j];
    row = (pid * a.Kv + kv) * a.page + off;
    sc = pid * a.Kv * a.page + static_cast<long long>(kv) * a.page + off;
  }
}

__device__ __forceinline__ long long partial_index(const Args& a, int s,
                                                   int kv, int sp) {
  return (static_cast<long long>(s) * a.Kv + kv) * a.n_split + sp;
}

// Every thread of the block: the empty partial of (s, kv, sp).
__device__ void write_empty(const Args& a, int s, int kv, int sp, int G,
                            int H) {
  const long long N = static_cast<long long>(gridDim.z) * a.Kv * a.n_split;
  const long long p = partial_index(a, s, kv, sp);
  float* acc = a.ws + p * G * H;
  float* m = a.ws + N * G * H + p * G;
  float* l = m + N * G;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) acc[i] = 0.f;
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    m[i] = NEG;
    l[i] = 0.f;
  }
}

// Merge NW warp states (m, l in base-2 units; heads strided by GS) in
// shared memory into the block's partial. The caller syncs first.
__device__ void write_partial(const Args& a, int s, int kv, int sp, int G,
                              int H, int NW, int GS, const float* wm,
                              const float* wl, const float* wacc) {
  const long long N = static_cast<long long>(gridDim.z) * a.Kv * a.n_split;
  const long long p = partial_index(a, s, kv, sp);
  float* acc = a.ws + p * G * H;
  float* m = a.ws + N * G * H + p * G;
  float* l = m + N * G;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    const int g = i / H, h = i - g * H;
    float M = NEG;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * GS + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(wm[w * GS + g] - M);
      L = fmaf(wl[w * GS + g], f, L);
      A = fmaf(wacc[(w * GS + g) * H + h], f, A);
    }
    acc[i] = A;
    if (h == 0) {
      m[g] = M;
      l[g] = L;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores: f32 queries, or query groups wider than 8
// ---------------------------------------------------------------------------

// One lane's VPL contiguous elements of a row, loaded as one vector.
template <typename KT, int VPL>
struct alignas(VPL * sizeof(KT) >= 16 ? 16 : VPL * sizeof(KT)) Vec {
  KT v[VPL];
};

template <typename KT, int VPL>
__device__ __forceinline__ void load_slice(const KT* row, int lane, int H,
                                           float* out) {
  if (lane * VPL < H) {
    const Vec<KT, VPL> x =
        *reinterpret_cast<const Vec<KT, VPL>*>(row + lane * VPL);
#pragma unroll
    for (int e = 0; e < VPL; ++e) out[e] = to_f(x.v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < VPL; ++e) out[e] = 0.f;
  }
}

// Warp-private online-softmax state (base-2 units), in shared memory.
struct WarpState {
  float* acc;  // [G][H]
  float* m;    // [G]
  float* l;    // [G]
};

// Fold CHUNK tokens (this lane's K/V slices kf/vf, validity ok, scales)
// into the warp's state for every query head of the group; `scale` is
// log2(e) / sqrt(H).
template <int H, int VPL, int CHUNK>
__device__ __forceinline__ void fold_chunk(
    const float (&kf)[CHUNK][VPL], const float (&vf)[CHUNK][VPL],
    const bool (&ok)[CHUNK], const float (&ksc)[CHUNK],
    const float (&vsc)[CHUNK], bool quant, int G, int lane, float scale,
    const float* q_s, WarpState st) {
  const int h0 = lane * VPL;
  const bool mine = h0 < H;
  for (int g = 0; g < G; ++g) {
    float qv[VPL];
#pragma unroll
    for (int e = 0; e < VPL; ++e) qv[e] = mine ? q_s[g * H + h0 + e] : 0.f;
    float sc[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) d = fmaf(qv[e], kf[t][e], d);
      sc[t] = d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < CHUNK; ++t)
        sc[t] += __shfl_xor_sync(FULL, sc[t], off);
    }
    const float m_prev = st.m[g];
    float mx = m_prev;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      float s = sc[t];
      if (quant) s *= ksc[t];
      s = ok[t] ? s * scale : NEG;
      sc[t] = s;
      mx = fmaxf(mx, s);
    }
    const float corr = exp2f(m_prev - mx);
    float lsum = 0.f;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const float p = ok[t] ? exp2f(sc[t] - mx) : 0.f;
      lsum += p;
      sc[t] = quant ? p * vsc[t] : p;  // V scale folds into the probs
    }
    if (mine) {
      float* ar = st.acc + g * H + h0;
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        float x = ar[e] * corr;
#pragma unroll
        for (int t = 0; t < CHUNK; ++t) x = fmaf(sc[t], vf[t][e], x);
        ar[e] = x;
      }
    }
    __syncwarp();
    if (lane == 0) {
      st.l[g] = st.l[g] * corr + lsum;
      st.m[g] = mx;
    }
    __syncwarp();
  }
}

template <typename T, typename KT, int H>
__global__ void __launch_bounds__(CC_WARPS * 32)
paged_cc_kernel(Args a) {
  constexpr int VPL = H >= 32 ? H / 32 : 1;       // elements per lane
  constexpr int CHUNK = VPL >= 8 ? 4 : 8;         // tokens per step
  extern __shared__ float smem[];
  const int sp = blockIdx.x, kv = blockIdx.y, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NW = blockDim.x >> 5;
  const int G = a.Nq / a.Kv;
  const Seg seg = block_segment(a, sp, s);
  if (seg.t0 >= seg.t1) {
    write_empty(a, s, kv, sp, G, H);
    return;
  }
  float* q_s = smem;                          // [G][H]
  float* acc_all = q_s + G * H;               // [NW][G][H]
  float* m_all = acc_all + NW * G * H;        // [NW][G]
  float* l_all = m_all + NW * G;              // [NW][G]
  WarpState st{acc_all + warp * G * H, m_all + warp * G, l_all + warp * G};

  const T* qg = static_cast<const T*>(a.q) +
                (static_cast<size_t>(s) * a.Nq + static_cast<size_t>(kv) * G) * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) q_s[i] = to_f(qg[i]);
  for (int i = lane; i < G * H; i += 32) st.acc[i] = 0.f;
  for (int g = lane; g < G; g += 32) {
    st.m[g] = NEG;
    st.l[g] = 0.f;
  }
  __syncthreads();

  const float scale = rsqrtf(static_cast<float>(H)) * LOG2E;
  const bool quant = a.k_scale != nullptr;
  const KT* kp = static_cast<const KT*>(seg.win ? a.win_k : a.k_pages);
  const KT* vp = static_cast<const KT*>(seg.win ? a.win_v : a.v_pages);
  const float* kss = seg.win ? a.win_k_scale : a.k_scale;
  const float* vss = seg.win ? a.win_v_scale : a.v_scale;
  for (int c0 = seg.t0 + warp * CHUNK; c0 < seg.t1; c0 += NW * CHUNK) {
    float kf[CHUNK][VPL], vf[CHUNK][VPL], ksc[CHUNK], vsc[CHUNK];
    bool ok[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const int n = c0 + t;
      ok[t] = n < seg.t1;
      ksc[t] = vsc[t] = 0.f;
      if (ok[t]) {
        long long row, sc;
        token_row(a, seg, s, kv, n, row, sc);
        load_slice<KT, VPL>(kp + row * H, lane, H, kf[t]);
        load_slice<KT, VPL>(vp + row * H, lane, H, vf[t]);
        if (quant) {
          ksc[t] = kss[sc];
          vsc[t] = vss[sc];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VPL; ++e) kf[t][e] = vf[t][e] = 0.f;
      }
    }
    fold_chunk<H, VPL, CHUNK>(kf, vf, ok, ksc, vsc, quant, G, lane, scale,
                              q_s, st);
  }
  __syncthreads();
  write_partial(a, s, kv, sp, G, H, NW, G, m_all, l_all, acc_all);
}

// ---------------------------------------------------------------------------
// Tensor cores: bf16 / f16 queries, G <= 8. Fragment layouts are the PTX
// ISA's for m16n8k16: lane (g = lane / 4, t = lane % 4) holds A rows g and
// g + 8 at columns 2t, 2t + 1 (+ 8), B column g at rows 2t, 2t + 1 (+ 8),
// C rows g and g + 8 at columns 2t, 2t + 1.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// transpose of an 8 x 8 b16 matrix held as one fragment register per lane
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// widen 16 int8 codes to 16 elements of T (two 16-byte stores)
template <typename T>
__device__ __forceinline__ void widen16(uint16_t* dst, const int8_t* src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
  uint4 lo, hi;
  lo.x = pack2<T>(c[0], c[1]);
  lo.y = pack2<T>(c[2], c[3]);
  lo.z = pack2<T>(c[4], c[5]);
  lo.w = pack2<T>(c[6], c[7]);
  hi.x = pack2<T>(c[8], c[9]);
  hi.y = pack2<T>(c[10], c[11]);
  hi.z = pack2<T>(c[12], c[13]);
  hi.w = pack2<T>(c[14], c[15]);
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// Shared memory of one warp of the tensor-core kernel, in bytes: STAGES
// stages of [K rows | V rows] (CH rows of H KT elements, padded by 16
// bytes so ldmatrix's 8 row reads hit different banks) + CH K and CH V
// scales; for int8 pools one widened [K | V] tile of CH x (H + 8) T.
template <typename KT, int H>
struct TcSmem {
  static constexpr int ROW = H * static_cast<int>(sizeof(KT)) + 16;
  static constexpr int STAGE = 2 * CH * ROW + 2 * CH * 4;
  static constexpr bool QUANT = sizeof(KT) == 1;
  static constexpr int WIDE_ROW = (H + 8) * 2;
  static constexpr int WIDE = QUANT ? 2 * CH * WIDE_ROW : 0;
  static constexpr int WARP = STAGES * STAGE + WIDE;
};

template <typename T, typename KT, int H>
__global__ void __launch_bounds__(TC_WARPS * 32)
paged_tc_kernel(Args a) {
  using L = TcSmem<KT, H>;
  constexpr bool QUANT = L::QUANT;
  constexpr int PR = H * static_cast<int>(sizeof(KT)) / 16;  // 16 B / row
  extern __shared__ uint4 smem_tc[];
  const int sp = blockIdx.x, kv = blockIdx.y, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.Nq / a.Kv;
  const Seg seg = block_segment(a, sp, s);
  if (seg.t0 >= seg.t1) {
    write_empty(a, s, kv, sp, G, H);
    return;
  }
  uint8_t* wbase = reinterpret_cast<uint8_t*>(smem_tc) + warp * L::WARP;

  // the group's queries as B fragments (head g of the group on N)
  uint32_t qb[H / 16][2];
  {
    const T* qrow = static_cast<const T*>(a.q) +
                    (static_cast<long long>(s) * a.Nq + kv * G + g) * H;
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const bool live = g < G;
      qb[kk][0] = live ? *reinterpret_cast<const uint32_t*>(
                             qrow + kk * 16 + 2 * t) : 0u;
      qb[kk][1] = live ? *reinterpret_cast<const uint32_t*>(
                             qrow + kk * 16 + 8 + 2 * t) : 0u;
    }
  }
  const float scale = rsqrtf(static_cast<float>(H)) * LOG2E;
  const KT* kp = static_cast<const KT*>(seg.win ? a.win_k : a.k_pages);
  const KT* vp = static_cast<const KT*>(seg.win ? a.win_v : a.v_pages);
  const float* kss = seg.win ? a.win_k_scale : a.k_scale;
  const float* vss = seg.win ? a.win_v_scale : a.v_scale;

  const int n_chunks = (seg.t1 - seg.t0 + CH - 1) / CH;
  const int mine = warp < n_chunks ? (n_chunks - warp + TC_WARPS - 1) /
                                         TC_WARPS : 0;

  // issue chunk i of this warp into stage i % STAGES
  auto issue = [&](int i) {
    const int c0 = seg.t0 + (warp + i * TC_WARPS) * CH;
    uint8_t* st = wbase + (i % STAGES) * L::STAGE;
    long long row = 0, sc = 0;
    const bool ok = lane < CH && c0 + lane < seg.t1;
    if (ok) token_row(a, seg, s, kv, c0 + lane, row, sc);
#pragma unroll
    for (int e = lane; e < 2 * CH * PR; e += 32) {
      const int kvsel = e / (CH * PR);
      const int r = (e - kvsel * CH * PR) / PR;
      const int pc = e - kvsel * CH * PR - r * PR;
      const long long rr = __shfl_sync(FULL, row, r);
      const bool v = __shfl_sync(FULL, ok, r);
      const KT* src = (kvsel ? vp : kp) + rr * H + pc * (16 / sizeof(KT));
      cp_async16(st + (kvsel * CH + r) * L::ROW + pc * 16, src, v);
    }
    if constexpr (QUANT) {
      float* scs = reinterpret_cast<float*>(st + 2 * CH * L::ROW);
      const int r = lane & (CH - 1);
      const long long sr = __shfl_sync(FULL, sc, r);
      const bool v = __shfl_sync(FULL, ok, r);
      const float* src = (lane < CH ? kss : vss) + sr;
      cp_async4(scs + lane, src, v);
    }
  };

  float acc[H / 16][4];
#pragma unroll
  for (int j = 0; j < H / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG, NEG};     // heads 2t, 2t + 1 (base-2 units)
  float lsum[2] = {0.f, 0.f};  // this lane's rows' share of l

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + STAGES - 1 < mine) issue(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const uint8_t* st = wbase + (i % STAGES) * L::STAGE;
    const int c0 = seg.t0 + (warp + i * TC_WARPS) * CH;
    const uint8_t* kt = st;
    const uint8_t* vt = st + CH * L::ROW;
    int ld = L::ROW;  // bytes per tile row
    if constexpr (QUANT) {
      uint16_t* wide = reinterpret_cast<uint16_t*>(wbase + STAGES * L::STAGE);
      for (int e = lane; e < 2 * CH * (H / 16); e += 32) {
        const int r = e / (H / 16), c = (e - r * (H / 16)) * 16;
        widen16<T>(wide + r * (H + 8) + c,
                   reinterpret_cast<const int8_t*>(st + r * L::ROW) + c);
      }
      __syncwarp();
      kt = reinterpret_cast<const uint8_t*>(wide);
      vt = kt + CH * L::WIDE_ROW;
      ld = L::WIDE_ROW;
    }
    // scores: [16 tokens] x [8 heads]
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const int mi = lane >> 3, r = lane & 7;
      const uint8_t* kr = kt + (r + (mi & 1) * 8) * ld + (mi >> 1) * 16;
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, kr + kk * 32);
        mma16816<T>(sc, af, qb[kk][0], qb[kk][1]);
      }
    }
    const bool ok0 = c0 + g < seg.t1, ok1 = c0 + g + 8 < seg.t1;
    float ks0 = 1.f, ks1 = 1.f, vs0 = 1.f, vs1 = 1.f;
    if constexpr (QUANT) {
      const float* scs = reinterpret_cast<const float*>(st + 2 * CH * L::ROW);
      ks0 = scs[g];
      ks1 = scs[g + 8];
      vs0 = scs[CH + g];
      vs1 = scs[CH + g + 8];
    }
    // rows g (sc[0], sc[1]) and g + 8 (sc[2], sc[3]); columns 2t, 2t + 1
    sc[0] = ok0 ? sc[0] * ks0 * scale : NEG;
    sc[1] = ok0 ? sc[1] * ks0 * scale : NEG;
    sc[2] = ok1 ? sc[2] * ks1 * scale : NEG;
    sc[3] = ok1 ? sc[3] * ks1 * scale : NEG;
    float p[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(sc[e], sc[e + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
      const float m_new = fmaxf(m[e], mx);
      const float corr = exp2f(m[e] - m_new);
      m[e] = m_new;
      p[e] = ok0 ? exp2f(sc[e] - m_new) : 0.f;
      p[e + 2] = ok1 ? exp2f(sc[e + 2] - m_new) : 0.f;
      lsum[e] = lsum[e] * corr + p[e] + p[e + 2];
#pragma unroll
      for (int j = 0; j < H / 16; ++j) {
        acc[j][e] *= corr;
        acc[j][e + 2] *= corr;
      }
    }
    if constexpr (QUANT) {  // the V scale, after the probability entered l
      p[0] *= vs0;
      p[1] *= vs0;
      p[2] *= vs1;
      p[3] *= vs1;
    }
    // P^T as the B operand: tokens on K, heads on N
    const uint32_t pb0 = movmatrix_trans(pack2<T>(p[0], p[1]));
    const uint32_t pb1 = movmatrix_trans(pack2<T>(p[2], p[3]));
    {
      const int mi = lane >> 3, r = lane & 7;
      const uint8_t* vr = vt + (r + (mi >> 1) * 8) * ld + (mi & 1) * 16;
#pragma unroll
      for (int j = 0; j < H / 16; ++j) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, vr + j * 32);
        mma16816<T>(acc[j], af, pb0, pb1);
      }
    }
    __syncwarp();  // this stage (and the widened tile) may be refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lsum[e] += __shfl_xor_sync(FULL, lsum[e], 4);
    lsum[e] += __shfl_xor_sync(FULL, lsum[e], 8);
    lsum[e] += __shfl_xor_sync(FULL, lsum[e], 16);
  }
  __syncthreads();  // every warp done with its stages: reuse them
  float* wm = reinterpret_cast<float*>(smem_tc);  // [TC_WARPS][8]
  float* wl = wm + TC_WARPS * 8;                  // [TC_WARPS][8]
  float* wacc = wl + TC_WARPS * 8;                // [TC_WARPS][8][H]
  if (g == 0) {
    wm[warp * 8 + 2 * t] = m[0];
    wm[warp * 8 + 2 * t + 1] = m[1];
    wl[warp * 8 + 2 * t] = lsum[0];
    wl[warp * 8 + 2 * t + 1] = lsum[1];
  }
  // acc[j]: rows h = 16j + g (+ 8), columns heads 2t, 2t + 1
#pragma unroll
  for (int j = 0; j < H / 16; ++j) {
    float* w0 = wacc + (warp * 8 + 2 * t) * H + 16 * j + g;
    w0[0] = acc[j][0];
    w0[H] = acc[j][1];
    w0[8] = acc[j][2];
    w0[H + 8] = acc[j][3];
  }
  __syncthreads();
  write_partial(a, s, kv, sp, G, H, TC_WARPS, 8, wm, wl, wacc);
}

// One block per (kv head, slot): the slot's partials merged in split
// order into the G query heads' outputs.
template <typename T>
__global__ void __launch_bounds__(128)
paged_merge_kernel(Args a, int H) {
  const int kv = blockIdx.x, s = blockIdx.y;
  const int G = a.Nq / a.Kv;
  const long long N = static_cast<long long>(gridDim.y) * a.Kv * a.n_split;
  const long long p0 = partial_index(a, s, kv, 0);
  const float* acc = a.ws + p0 * G * H;
  const float* m = a.ws + N * G * H + p0 * G;
  const float* l = m + N * G;
  T* out = static_cast<T*>(a.out) +
           (static_cast<long long>(s) * a.Nq + static_cast<long long>(kv) * G) * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    const int g = i / H;
    float M = NEG;
    for (int k = 0; k < a.n_split; ++k) M = fmaxf(M, m[k * G + g]);
    float Ls = 0.f, A = 0.f;
    for (int k = 0; k < a.n_split; ++k) {
      const float f = exp2f(m[k * G + g] - M);
      Ls = fmaf(l[k * G + g], f, Ls);
      A = fmaf(acc[static_cast<long long>(k) * G * H + i], f, A);
    }
    out[i] = from_f<T>(A / fmaxf(Ls, 1e-30f));
  }
}

template <typename Kernel>
int allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, typename KT, int H>
int launch_splits(const Args& a, int S, cudaStream_t stream) {
  const int G = a.Nq / a.Kv;
  const dim3 grid(a.n_split, a.Kv, S);
  if constexpr (!std::is_same<T, float>::value) {
    if (G <= 8) {
      const size_t bytes = static_cast<size_t>(TC_WARPS) * TcSmem<KT, H>::WARP;
      auto kern = paged_tc_kernel<T, KT, H>;
      const int e = allow_smem(kern, bytes);
      if (e != 0) return e;
      kern<<<grid, TC_WARPS * 32, bytes, stream>>>(a);
      return static_cast<int>(cudaGetLastError());
    }
  }
  // as many warps as shared memory allows (each holds a G x H state)
  const size_t per_warp = static_cast<size_t>(G) * (H + 2) * sizeof(float);
  const size_t base = static_cast<size_t>(G) * H * sizeof(float);
  const size_t cap = 200 * 1024;
  int nw = CC_WARPS;
  while (nw > 1 && base + nw * per_warp > cap) --nw;
  const size_t bytes = base + nw * per_warp;
  if (bytes > cap) return -2;  // the group's state does not fit
  auto kern = paged_cc_kernel<T, KT, H>;
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  kern<<<grid, nw * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KT, int H>
int launch(const Args& a, int S, cudaStream_t stream) {
  const int e = launch_splits<T, KT, H>(a, S, stream);
  if (e != 0) return e;
  paged_merge_kernel<T><<<dim3(a.Kv, S), 128, 0, stream>>>(a, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KT>
int launch_h(const Args& a, int S, int H, cudaStream_t stream) {
  switch (H) {
    case 16: return launch<T, KT, 16>(a, S, stream);
    case 32: return launch<T, KT, 32>(a, S, stream);
    case 64: return launch<T, KT, 64>(a, S, stream);
    case 128: return launch<T, KT, 128>(a, S, stream);
    case 256: return launch<T, KT, 256>(a, S, stream);
    default: return -1;
  }
}

template <typename T>
int launch_q(const Args& a, int quant, int S, int H, cudaStream_t stream) {
  return quant ? launch_h<T, int8_t>(a, S, H, stream)
               : launch_h<T, T>(a, S, H, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (the query's and, when
// quant == 0, the pool's type). quant != 0: int8 pools with f32 scales.
// ws: f32 workspace of S * Kv * n_split * G * (H + 2) floats; the split
// plan (split_pages, n_page_splits, n_split) is ops/paged_attention.py's
// split_plan. Returns 0 on success, -1 for an unsupported dtype or
// head_dim, -2 when the query group's state does not fit in shared memory,
// else the cudaError_t of a launch.
extern "C" int bt_paged_attention(
    int dtype, int quant, const void* q, const void* k_pages,
    const void* v_pages, const float* k_scale, const float* v_scale,
    const int* table, const int* lengths, const void* win_k,
    const void* win_v, const float* win_k_scale, const float* win_v_scale,
    const int* win_count, void* out, float* ws, int S, int Nq, int Kv,
    int H, int page, int max_pages, int W, int split_pages,
    int n_page_splits, int n_split, void* stream) {
  Args a{q, k_pages, v_pages, k_scale, v_scale, table, lengths, win_k,
         win_v, win_k_scale, win_v_scale, win_count, out, ws, Nq, Kv, page,
         max_pages, W, split_pages, n_page_splits, n_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_q<float>(a, quant, S, H, st);
    case 1: return launch_q<__half>(a, quant, S, H, st);
    case 2: return launch_q<__nv_bfloat16>(a, quant, S, H, st);
    default: return -1;
  }
}
