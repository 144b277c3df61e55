// The warm flash prefill (a chunk continuation) on Hopper's warpgroup MMA
// (wgmma), for bf16 / f16 at head dims 64 and 128 (GPT-2, Llama-3-8B):
// see flash_warm_wg_kernel. The wgmma primitives are wgmma_common.cuh's,
// shared with the fresh and ring kernels; this body is its own.
//
// * A block owns BQ = 128 query rows of one query head (two warpgroups of
//   64 rows). ONE online-softmax state runs first over the cached prefix
//   of its batch row, then over the causal fresh chunk: a single walk
//   over np prefix tiles followed by the fresh chunk's tiles up to the
//   block's diagonal, all streamed through one 2-stage cp.async ring.
// * Prefix tiles: columns below prefix_len[b] count, with no causal
//   triangle. Tiles wholly past prefix_len[b] are never walked; only the
//   tile that holds its end is masked. Key rows at or past it are
//   zero-filled by cp.async, never read, so garbage past the length
//   never reaches a product.
// * A float prefix is read through its (batch, row, head) strides: the
//   gathered pool view and generate's contiguous cache alike. int8 codes
//   [B, Kv, Sp, H] arrive raw by cp.async and are widened to q's dtype
//   into the swizzled stage before the MMA; their K scale multiplies the
//   score columns before the max, the V scale the probabilities after
//   they entered the denominator, as on the TPU.
// * Fresh tiles run exactly as flash_fresh_wg_kernel's causal ones: a
//   warpgroup skips a tile wholly above its diagonal; only tiles that
//   cross the diagonal or the ragged end T are masked.
// * Every row's first walked tile holds a live key (prefix column 0, or
//   fresh key 0), so a masked score (-1e30) gives exactly 0 from then on.
// * Load balance: a block's work grows with its row's prefix_len. The
//   grid runs heaviest first without a host read: each block ranks the B
//   prefix lengths itself (longest first, ties by row) and takes the row
//   of its rank; query tiles run last to first, query heads fastest (a kv
//   group's heads adjacent, sharing K/V tiles through L2).
//   ops/flash_attention.py:warm_block_order is the same order in Python.
#pragma once

#include "wgmma_common.cuh"

namespace bt {
namespace wg {

struct WarmArgs {
  const void* q;     // [B, T, Nq, H]
  const void* k;     // [B, T, Kv, H], the fresh chunk
  const void* v;
  void* out;         // [B, T, Nq, H]
  const void* pk;    // prefix rows (b, c, kv) at b*psb + c*pss + kv*psh
  const void* pv;
  const float* pks;  // [B, Kv, Sp] iff the prefix is int8
  const float* pvs;
  const int* plen;   // [B]
  long long psb, pss, psh;
  int B, T, Nq, Kv, Sp, ntiles;
};

__device__ __forceinline__ int clamp_plen(const WarmArgs& a, int b) {
  const int p = a.plen[b];
  return p < 0 ? 0 : (p > a.Sp ? a.Sp : p);
}

// The batch row of rank r when rows are ordered by prefix_len, longest
// first, ties by row index. Every thread of the block calls it.
__device__ __forceinline__ int warm_row_of_rank(const WarmArgs& a, int r,
                                                int* row_s) {
  for (int b = threadIdx.x; b < a.B; b += NTHREADS) {
    const int pb = clamp_plen(a, b);
    int rank = 0;
    for (int o = 0; o < a.B; ++o) {
      const int po = clamp_plen(a, o);
      rank += po > pb || (po == pb && o < b);
    }
    if (rank == r) *row_s = b;
  }
  __syncthreads();
  return *row_s;
}

// Two blocks per SM for a float prefix (as the fresh kernel); the int8
// prefix's raw stages take the shared memory of a second block.
template <typename T, typename PT, int H>
__global__ void __launch_bounds__(NTHREADS, sizeof(PT) == 1 ? 1 : 2)
flash_warm_wg_kernel(WarmArgs a) {
  constexpr bool QUANT = sizeof(PT) == 1;
  constexpr int Q_BYTES = BQ * H * 2;
  constexpr int KV_BYTES = BKW * H * 2;
  constexpr int RAW_BYTES = BKW * H;  // one int8 tile, row-major
  constexpr int C16 = H / 8;          // 16-byte chunks per row (T)
  constexpr int R16 = H / 16;         // 16-byte chunks per row (int8)
  constexpr int NS = BKW / 2;         // score accumulators per thread
  extern __shared__ __align__(128) uint8_t wg_smem[];
  const uint32_t pad = (1024u - (smem_u32(wg_smem) & 1023u)) & 1023u;
  uint8_t* qs = wg_smem + pad;               // [H/64][BQ][128 B]
  uint8_t* ks = qs + Q_BYTES;                // [STAGES][H/64][BKW][128 B]
  uint8_t* vs = ks + STAGES * KV_BYTES;
  int8_t* kraw = reinterpret_cast<int8_t*>(vs + STAGES * KV_BYTES);
  int8_t* vraw = kraw + STAGES * RAW_BYTES;  // [STAGES][BKW][H] (int8)
  float* ksc = reinterpret_cast<float*>(vraw + STAGES * RAW_BYTES);
  float* vsc = ksc + BKW;                    // [BKW] scales (int8)
  __shared__ int row_s;

  int bid = blockIdx.x;
  const int n = bid % a.Nq;
  bid /= a.Nq;
  const int q0 = (a.ntiles - 1 - bid % a.ntiles) * BQ;
  const int b = warm_row_of_rank(a, bid / a.ntiles, &row_s);
  const int kv = n / (a.Nq / a.Kv);
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qstride = static_cast<long long>(a.Nq) * H;
  const long long kstride = static_cast<long long>(a.Kv) * H;
  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<long long>(b) * a.T * a.Nq + n) * H;
  const T* kb = static_cast<const T*>(a.k) +
                (static_cast<long long>(b) * a.T * a.Kv + kv) * H;
  const T* vb = static_cast<const T*>(a.v) +
                (static_cast<long long>(b) * a.T * a.Kv + kv) * H;
  const long long poff = static_cast<long long>(b) * a.psb +
                         static_cast<long long>(kv) * a.psh;
  const PT* pkb = static_cast<const PT*>(a.pk) + poff;
  const PT* pvb = static_cast<const PT*>(a.pv) + poff;
  const long long srow = (static_cast<long long>(b) * a.Kv + kv) * a.Sp;
  const int plen = clamp_plen(a, b);
  const int np = (plen + BKW - 1) / BKW;     // prefix tiles
  const int kend = min(a.T, q0 + BQ);
  const int nk = np + (kend + BKW - 1) / BKW;

  for (int e = tid; e < BQ * C16; e += NTHREADS) {
    const int r = e / C16, ch = e - r * C16;
    const bool ok = q0 + r < a.T;
    cp_async16(qs + swz<BQ>(r, ch),
               qb + (ok ? q0 + r : 0) * qstride + ch * 8, ok);
  }
  // tile j < np: prefix rows j*BKW.. (below plen); else fresh keys
  auto load_kv = [&](int j) {
    const int st = j % STAGES;
    if (j < np) {
      const int c0 = j * BKW;
      if constexpr (QUANT) {
        for (int e = tid; e < BKW * R16; e += NTHREADS) {
          const int r = e / R16, ch = e - r * R16;
          const bool ok = c0 + r < plen;
          const long long off = (ok ? c0 + r : 0) * a.pss + ch * 16;
          cp_async16(kraw + st * RAW_BYTES + r * H + ch * 16, pkb + off, ok);
          cp_async16(vraw + st * RAW_BYTES + r * H + ch * 16, pvb + off, ok);
        }
      } else {
        for (int e = tid; e < BKW * C16; e += NTHREADS) {
          const int r = e / C16, ch = e - r * C16;
          const bool ok = c0 + r < plen;
          const long long off = (ok ? c0 + r : 0) * a.pss + ch * 8;
          cp_async16(ks + st * KV_BYTES + swz<BKW>(r, ch), pkb + off, ok);
          cp_async16(vs + st * KV_BYTES + swz<BKW>(r, ch), pvb + off, ok);
        }
      }
    } else {
      const int c0 = (j - np) * BKW;
      for (int e = tid; e < BKW * C16; e += NTHREADS) {
        const int r = e / C16, ch = e - r * C16;
        const bool ok = c0 + r < a.T;
        const long long off = (ok ? c0 + r : 0) * kstride + ch * 8;
        cp_async16(ks + st * KV_BYTES + swz<BKW>(r, ch), kb + off, ok);
        cp_async16(vs + st * KV_BYTES + swz<BKW>(r, ch), vb + off, ok);
      }
    }
  };
  load_kv(0);  // nk >= 1: the fresh chunk has a tile; Q rides along
  cp_async_commit();

  float o[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of rows a, b's denominators
  const float scale2 = rsqrtf(static_cast<float>(H)) * LOG2E;
  const int r0 = q0 + wgi * 64;  // the warpgroup's first query row
  const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;
  const uint32_t qaddr = smem_u32(qs) + wgi * 64 * 128;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile j landed
    fence_proxy_async();
    __syncthreads();  // tile j staged by all; tile j - 1's stage is free
    if (j + STAGES - 1 < nk) load_kv(j + STAGES - 1);
    cp_async_commit();
    const bool pre = j < np;  // block-uniform
    const int c0 = pre ? j * BKW : (j - np) * BKW;
    const int st = j % STAGES;
    if constexpr (QUANT) {
      if (pre) {  // widen the raw codes into the stage; stage the scales
        widen_tile<T, H, BKW>(ks + st * KV_BYTES, kraw + st * RAW_BYTES);
        widen_tile<T, H, BKW>(vs + st * KV_BYTES, vraw + st * RAW_BYTES);
        if (tid < 2 * BKW) {
          const int c = c0 + (tid & (BKW - 1));
          const float* src = tid < BKW ? a.pks : a.pvs;
          (tid < BKW ? ksc : vsc)[tid & (BKW - 1)] =
              c < plen ? src[srow + c] : 0.f;
        }
        fence_proxy_async();
        __syncthreads();
      }
    }
    if (pre || c0 <= r0 + 63) {  // some pair of this warpgroup lives
      const uint32_t kaddr = smem_u32(ks + st * KV_BYTES);
      const uint32_t vaddr = smem_u32(vs + st * KV_BYTES);
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const uint32_t koff = (kk & 3) * 32;  // 16 elements in the block
        wgmma_ss<T, BKW>(
            s, desc_sw128(qaddr + (kk >> 2) * (BQ * 128) + koff, 16, 1024),
            desc_sw128(kaddr + (kk >> 2) * (BKW * 128) + koff, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // s[4jj + e]: row a (e < 2) or b, column c0 + 8jj + 2t + (e & 1)
      if (pre) {
        if constexpr (QUANT) {  // the K scale, before the max
#pragma unroll
          for (int i = 0; i < NS; ++i)
            s[i] *= ksc[8 * (i >> 2) + 2 * t + (i & 1)];
        }
        if (c0 + BKW > plen) {  // the tile that holds the prefix's end
#pragma unroll
          for (int i = 0; i < NS; ++i)
            if (c0 + 8 * (i >> 2) + 2 * t + (i & 1) >= plen) s[i] = NEG;
        }
      } else if (c0 + BKW - 1 > r0 || c0 + BKW > a.T) {
#pragma unroll
        for (int jj = 0; jj < BKW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + jj * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (!(col < a.T && col <= row)) s[4 * jj + e] = NEG;
          }
      }
      // running max in raw score units (the scale is positive)
      float corr[2], ms[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = row_reduce<BKW, true>(s, h);
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        corr[h] = fast_exp2((m[h] - m_new) * scale2);
        m[h] = m_new;
        ms[h] = m_new * scale2;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = fast_exp2(fmaf(s[i], scale2, -ms[(i >> 1) & 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = l[h] * corr[h] + row_reduce<BKW, false>(s, h);
#pragma unroll
      for (int i = 0; i < H / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      if constexpr (QUANT) {  // the V scale, after l summed the probability
        if (pre) {
#pragma unroll
          for (int i = 0; i < NS; ++i)
            s[i] *= vsc[8 * (i >> 2) + 2 * t + (i & 1)];
        }
      }

      uint32_t pa[BKW / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk) {
        pa[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk)
        wgmma_rs<T, H>(o, pa[kk],
                       desc_sw128(vaddr + kk * 16 * 128, BKW * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
  }

  T* ob = static_cast<T*>(a.out) +
          (static_cast<long long>(b) * a.T * a.Nq + n) * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    const int row = h ? row_b : row_a;
    if (row < a.T) {
      const float inv = __frcp_rn(fmaxf(l[h], 1e-30f));
#pragma unroll
      for (int jj = 0; jj < H / 8; ++jj)
        *reinterpret_cast<uint32_t*>(ob + row * qstride + jj * 8 + 2 * t) =
            pack2<T>(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
    }
  }
}

template <typename T, typename PT, int H>
int launch_warm_wg(const WarmArgs& a, cudaStream_t stream) {
  constexpr bool QUANT = sizeof(PT) == 1;
  const size_t bytes = 1024 + BQ * H * 2 + 2 * STAGES * BKW * H * 2 +
                       (QUANT ? 2 * STAGES * BKW * H + 2 * BKW * 4 : 0);
  auto kern = flash_warm_wg_kernel<T, PT, H>;
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  kern<<<a.ntiles * a.Nq * a.B, NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace bt
