// Paged decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces butterfly_tpu/ops/paged_attention.py:_paged_kernel (the Pallas
// TPU kernel): one decode token of attention per slot over the paged KV
// pool, walking the slot's block table over the pages below lengths[s]
// with an online softmax, plus an optional write-combined window segment
// of win_count[s] staged tokens folded into the same recurrence.
//
// What bounds it on this card: HBM bytes. A decode step does ~2 flops per
// K/V byte it reads, far below the ~295 flops/byte where the tensor cores
// would become the limit, so the only lever is to read the live K/V once
// and keep enough loads in flight.
//
// Design, for the card rather than carried over from the Pallas grid:
// * one thread block per (slot, kv head). The block serves that kv head's
//   G = Nq / Kv query heads, so each K/V byte is read from HBM once per
//   kv group (the Pallas kernel's Kv-fold redundant [Nq, Kv*page] score
//   row is gone). The block reads page_table[s, j] itself for the pages
//   below lengths[s] (the TPU's scalar prefetch).
// * inside the block every warp runs its OWN online softmax over a
//   strided share of the tokens, CHUNK tokens at a time: each lane loads
//   its contiguous H/32 slice of each token's K and V row (one vector
//   load per row, coalesced across the warp), the G dot products reduce
//   with warp shuffles, and the f32 running max, denominator and
//   accumulator stay warp-private (shared memory, no block barrier in
//   the loop). One barrier at the end merges the warps' states.
// * int8 pools: the codes stream as they are; the K scale multiplies the
//   score and the V scale multiplies the probability, as the TPU kernel
//   does, never a dequantized copy.
// * masking contract: a masked score is the finite -1e30, a masked
//   probability is exactly 0, the output is acc / max(l, 1e-30), and a
//   slot with nothing to attend returns zeros.
//
// Not yet done (a later change): splitting one slot's pages across
// blocks (flash-decoding), TMA and wgmma. A long slot stays on one SM;
// with S x Kv = 64 blocks at the default batch of 8 the grid fills fewer
// than half of the 132 SMs.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;  // warps per block (256 threads)

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
  int Nq, Kv, page, max_pages, W;
};

// Warp-private online-softmax state, in shared memory.
struct WarpState {
  float* acc;  // [G][H]
  float* m;    // [G]
  float* l;    // [G]
};

// Fold CHUNK tokens (this lane's K/V slices kf/vf, validity ok, scales)
// into the warp's state for every query head of the group.
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
      s = ok[t] ? s * scale : -1e30f;
      sc[t] = s;
      mx = fmaxf(mx, s);
    }
    const float corr = expf(m_prev - mx);
    float lsum = 0.f;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const float p = ok[t] ? expf(sc[t] - mx) : 0.f;
      lsum += p;
      sc[t] = quant ? p * vsc[t] : p;  // V scale folds into the probs
    }
    if (mine) {
      float* ar = st.acc + g * H + h0;
#pragma unroll
      for (int e = 0; e < VPL; ++e) {
        float a = ar[e] * corr;
#pragma unroll
        for (int t = 0; t < CHUNK; ++t) a = fmaf(sc[t], vf[t][e], a);
        ar[e] = a;
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
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_attention_kernel(Args a) {
  constexpr int VPL = H >= 32 ? H / 32 : 1;       // elements per lane
  constexpr int CHUNK = VPL >= 8 ? 4 : 8;         // tokens per step
  extern __shared__ float smem[];
  const int s = blockIdx.x, kv = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NW = blockDim.x >> 5;
  const int G = a.Nq / a.Kv;
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
    st.m[g] = -INFINITY;
    st.l[g] = 0.f;
  }
  __syncthreads();

  const float scale = rsqrtf(static_cast<float>(H));
  const bool quant = a.k_scale != nullptr;
  const KT* kp = static_cast<const KT*>(a.k_pages);
  const KT* vp = static_cast<const KT*>(a.v_pages);
  int length = a.lengths[s];
  if (length > a.max_pages * a.page) length = a.max_pages * a.page;
  const int* trow = a.table + static_cast<size_t>(s) * a.max_pages;
  for (int c0 = warp * CHUNK; c0 < length; c0 += NW * CHUNK) {
    float kf[CHUNK][VPL], vf[CHUNK][VPL], ksc[CHUNK], vsc[CHUNK];
    bool ok[CHUNK];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const int n = c0 + t;
      ok[t] = n < length;
      ksc[t] = vsc[t] = 0.f;
      if (ok[t]) {
        const int j = n / a.page, off = n - j * a.page;
        const size_t pid = static_cast<size_t>(trow[j]);
        const size_t row = (pid * a.Kv + kv) * a.page + off;
        load_slice<KT, VPL>(kp + row * H, lane, H, kf[t]);
        load_slice<KT, VPL>(vp + row * H, lane, H, vf[t]);
        if (quant) {
          const size_t sc = pid * a.Kv * a.page +
                            static_cast<size_t>(kv) * a.page + off;
          ksc[t] = a.k_scale[sc];
          vsc[t] = a.v_scale[sc];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VPL; ++e) kf[t][e] = vf[t][e] = 0.f;
      }
    }
    fold_chunk<H, VPL, CHUNK>(kf, vf, ok, ksc, vsc, quant, G, lane, scale,
                              q_s, st);
  }
  if (a.win_k != nullptr) {
    int wc = a.win_count[s];
    if (wc > a.W) wc = a.W;
    const size_t wrow = (static_cast<size_t>(s) * a.Kv + kv) * a.W;
    const KT* wk = static_cast<const KT*>(a.win_k);
    const KT* wv = static_cast<const KT*>(a.win_v);
    for (int c0 = warp * CHUNK; c0 < wc; c0 += NW * CHUNK) {
      float kf[CHUNK][VPL], vf[CHUNK][VPL], ksc[CHUNK], vsc[CHUNK];
      bool ok[CHUNK];
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        const int n = c0 + t;
        ok[t] = n < wc;
        ksc[t] = vsc[t] = 0.f;
        if (ok[t]) {
          load_slice<KT, VPL>(wk + (wrow + n) * H, lane, H, kf[t]);
          load_slice<KT, VPL>(wv + (wrow + n) * H, lane, H, vf[t]);
          if (quant) {
            ksc[t] = a.win_k_scale[wrow + n];
            vsc[t] = a.win_v_scale[wrow + n];
          }
        } else {
#pragma unroll
          for (int e = 0; e < VPL; ++e) kf[t][e] = vf[t][e] = 0.f;
        }
      }
      fold_chunk<H, VPL, CHUNK>(kf, vf, ok, ksc, vsc, quant, G, lane, scale,
                                q_s, st);
    }
  }
  __syncthreads();
  // merge the warps' (m, l, acc) states; a warp that saw no token has
  // m = -inf and contributes nothing; no token at all gives zeros
  T* og = static_cast<T*>(a.out) +
          (static_cast<size_t>(s) * a.Nq + static_cast<size_t>(kv) * G) * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    const int g = i / H;
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_all[w * G + g]);
    float L = 0.f, A = 0.f;
    if (M > -INFINITY) {
      for (int w = 0; w < NW; ++w) {
        const float mw = m_all[w * G + g];
        if (mw > -INFINITY) {
          const float f = expf(mw - M);
          L = fmaf(l_all[w * G + g], f, L);
          A = fmaf(acc_all[(w * G + g) * H + (i - g * H)], f, A);
        }
      }
    }
    og[i] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename KT, int H>
int launch(const Args& a, int S, cudaStream_t stream) {
  const int G = a.Nq / a.Kv;
  // as many warps as shared memory allows (each holds a G x H state)
  const size_t per_warp = static_cast<size_t>(G) * (H + 2) * sizeof(float);
  const size_t base = static_cast<size_t>(G) * H * sizeof(float);
  const size_t cap = 200 * 1024;
  int nw = MAX_WARPS;
  while (nw > 1 && base + nw * per_warp > cap) --nw;
  const size_t bytes = base + nw * per_warp;
  if (bytes > cap) return -2;  // the group's state does not fit
  auto kern = paged_attention_kernel<T, KT, H>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(S, a.Kv), nw * 32, bytes, stream>>>(a);
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
// Returns 0 on success, -1 for an unsupported dtype or head_dim, -2 when
// the query group's state does not fit in shared memory, else the
// cudaError_t of the launch.
extern "C" int bt_paged_attention(
    int dtype, int quant, const void* q, const void* k_pages,
    const void* v_pages, const float* k_scale, const float* v_scale,
    const int* table, const int* lengths, const void* win_k,
    const void* win_v, const float* win_k_scale, const float* win_v_scale,
    const int* win_count, void* out, int S, int Nq, int Kv, int H, int page,
    int max_pages, int W, void* stream) {
  Args a{q, k_pages, v_pages, k_scale, v_scale, table, lengths, win_k,
         win_v, win_k_scale, win_v_scale, win_count, out, Nq, Kv, page,
         max_pages, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_q<float>(a, quant, S, H, st);
    case 1: return launch_q<__half>(a, quant, S, H, st);
    case 2: return launch_q<__nv_bfloat16>(a, quant, S, H, st);
    default: return -1;
  }
}
