// Ring-attention block kernels for Hopper (sm_90a), with a plain C
// interface.
//
// Replace the Pallas TPU kernel _ring_kernel of
// butterfly_tpu/ops/ring_attention.py (:158, its pallas_call at :259): the
// UNNORMALISED partial flash statistics of one K/V block,
//   m [B, Nq, T]   the max live score,
//   l [B, Nq, T]   sum of exp(s - m) over the live keys,
//   acc [B, Nq, T, H]  sum of exp(s - m) * v,
// all f32, which the seq-parallel paths merge across ring steps and
// shards (ops/ring_attention.py merge_stats) before one finalize.
// Query head n reads kv head n / (Nq / Kv); outputs are in head order.
// Scores are q.k in f32, times the K scale of the column (int8 K/V),
// times rsqrt(H). The ONE mask is k_pos <= q_pos (causality, raggedness
// and padding all arrive as positions; invalid keys carry INT32_MAX), so
// nothing assumes a key's position is its index. A masked score is -1e30
// and a masked probability exactly 0; a row with no live key returns
// exactly m = -1e30, l = 0, acc = 0, also when every tile of it is
// skipped, because merge_stats has no guards against -inf or NaN. No
// atomics touch an output: a relaunch gives the same bits.
//
// What bounds it on this card: a diagonal ring block of the 4096-token
// Llama-3-8B prefill (T = S = 2048 per shard, Nq = 32, Kv = 8, H = 128)
// does ~34 GFLOP (2.1M live pairs per head, q.k and p.v) for ~59 MB moved
// (q, k, v in bf16; m, l, acc out in f32, acc alone 33.5 MB): ~580 flops
// per byte, above the ~295 where the tensor cores and not HBM are the
// limit, so it is bound by OPERATIONS, and an earlier block (every key
// live) twice as much. A later block (every key masked) only has to
// write its outputs, and a decode step (T = 1) to read the shard's K/V:
// both are bound by BYTES.
//
// Routes, by shape and type (head dims 16, 32, 64, 128, 256; f32, bf16,
// f16; float or int8 K/V):
// * T = 1 (every generate_long decode step, prefix shards and suffix):
//   split over the keys (flash-decoding). Grid (n_split, Kv * NG, B):
//   split i folds keys [i * split, (i + 1) * split) for up to HG = 8
//   query heads of one kv head (NG = ceil(G / 8) head groups), so a
//   2048-key shard spreads over n_split blocks per kv head instead of one
//   block per query head with 63 of its 64 rows idle. The plan comes from
//   the static S alone (ops/ring_attention.py:ring_split_plan); nothing
//   is read on the host. bf16 / f16 at H = 64 / 128 run
//   ring_decode_tc_kernel: 4 warps, each streaming its own 16-key chunks
//   through a 3-stage warp-private cp.async ring, Q.K^T and P.V on
//   mma.sync m16n8k16 with the keys on M and the group's heads on N (K by
//   ldmatrix, P turned into the B operand by movmatrix.trans, V^T by
//   ldmatrix.trans), as the paged decode kernel does; f32, and bf16 / f16
//   at H = 16 / 32 / 256, run ring_decode_cc_kernel on the CUDA cores
//   under the same grid. A split whose keys are all masked writes the
//   exact empty partial. Partials go to an f32 workspace and
//   ring_merge_kernel merges each row's in split order into the raw
//   (m, l, acc) (no normalisation: the ring contract is unnormalised
//   stats); with one split the split kernel writes them itself.
// * T > 1, bf16 / f16 at H = 64 / 128 (the prefill ring blocks and the
//   serving lane's chunks): ring_wg_kernel on Hopper's warpgroup MMA, with
//   the primitives of wgmma_common.cuh and a body of its own: 128-row blocks
//   of two warpgroups, wgmma m64n64k16 for Q.K^T from 128-byte-swizzled
//   shared memory, P from registers for P.V with V read through the
//   transpose bit, a 2-stage cp.async K/V ring, base-2 softmax with the
//   scale folded into one FFMA, a kv group's heads in adjacent blocks,
//   query tiles last to first. Before the walk each block reduces every
//   key tile's smallest and largest position: a tile whose smallest
//   position exceeds the block's largest query position is never loaded
//   (the causal saving on the diagonal block; a later block loads
//   nothing), a warpgroup skips a tile that none of its rows sees, and
//   masks apply only on tiles where some pair is masked (positions cross,
//   or some key is invalid or past S); everywhere else the softmax runs
//   unmasked. int8 codes arrive raw by cp.async and are widened to q's
//   type into the swizzled tile before the MMA.
// * T > 1 in f32, and bf16 / f16 at H = 16 / 32 / 256: ring_kernel on the
//   CUDA cores in f32 (flash_tiles.cuh's fold_tile with the position
//   rule, 64-row blocks; 16-bit queries and keys widen on the way in and
//   nothing is rounded before the stats), as the fresh flash kernel
//   serves those head dims.
// Float K/V [B, S, Kv, H] and int8 codes [B, Kv, S, H] are both read
// through (batch, key, head) element strides; int8 scales fold as on the
// TPU: the K scale multiplies the score, the V scale the probability
// after it entered l. Any other head dim or type raises in the wrapper.

#include "flash_tiles.cuh"
#include "wgmma_common.cuh"

#include <climits>
#include <type_traits>

namespace {

using namespace bt;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

struct RingArgs {
  const void* q;      // [B, T, Nq, H] contiguous
  const void* k;      // key (b, c, kv) rows at b*ksb + c*kss + kv*ksh
  const void* v;      // same strides as k
  const float* ks;    // [B, Kv, S] iff int8
  const float* vs;
  const int* qpos;    // [B, T]
  const int* kpos;    // [B, S]
  float* m;           // [B, Nq, T]
  float* l;           // [B, Nq, T]
  float* acc;         // [B, Nq, T, H]
  float* ws;          // T = 1 split partials: acc [B, Nq, n_split, H],
                      // then m, l [B, Nq, n_split] (base-2 units)
  long long ksb, kss, ksh;
  int T, S, Nq, Kv;
  int split, n_split; // T = 1: keys per split, splits
};

// Stage the block's query positions (rows past T get INT_MIN: they are
// never written) and return the largest valid one, block-wide.
__device__ __forceinline__ int stage_qpos(const RingArgs& a, int b, int q0,
                                          int* qps, int* qmax_s) {
  if (threadIdx.x == 0) *qmax_s = INT_MIN;
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    const int row = q0 + r;
    const int p = row < a.T ? a.qpos[static_cast<long long>(b) * a.T + row]
                            : INT_MIN;
    qps[r] = p;
    if (row < a.T) atomicMax(qmax_s, p);
  }
  __syncthreads();
  return *qmax_s;
}

// Stage tile c0's key positions (keys past S are invalid) and report
// whether any of them is at or before qmax, block-wide; the barrier also
// publishes kps. Every thread of the block must call it.
__device__ __forceinline__ bool stage_kpos(const RingArgs& a, int b, int c0,
                                           int qmax, int* kps) {
  bool live = false;
  if (threadIdx.x < BK) {
    const int c = c0 + threadIdx.x;
    const int p = c < a.S ? a.kpos[static_cast<long long>(b) * a.S + c]
                          : INT_MAX;
    kps[threadIdx.x] = p;
    live = p <= qmax;
  }
  return __syncthreads_or(live) != 0;
}

template <typename KT>
struct Block {  // one (batch row, kv head)'s operands
  const KT* kb;
  const KT* vb;
  const float* ksg;
  const float* vsg;
};

template <typename KT, bool QUANT>
__device__ __forceinline__ Block<KT> block_of(const RingArgs& a, int b,
                                              int kv) {
  const long long off = static_cast<long long>(b) * a.ksb +
                        static_cast<long long>(kv) * a.ksh;
  Block<KT> blk{static_cast<const KT*>(a.k) + off,
                static_cast<const KT*>(a.v) + off, nullptr, nullptr};
  if constexpr (QUANT) {
    const long long srow = (static_cast<long long>(b) * a.Kv + kv) * a.S;
    blk.ksg = a.ks + srow;
    blk.vsg = a.vs + srow;
  }
  return blk;
}

// T > 1 on the CUDA cores: q of type QT (f32, or bf16 / f16 widened as it
// is staged), K/V of type KT (QT, or int8 codes).
template <typename QT, typename KT, int H, bool QUANT>
__global__ void __launch_bounds__(NT) ring_kernel(RingArgs a) {
  constexpr int LD = H + 4;
  constexpr int NJ = H / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* kvs = qs + BQ * LD;                    // [BK][LD], K then V
  float* ps = kvs + BK * LD;                    // [BQ][LDP]
  float* ksc = ps + BQ * LDP;                   // [BK] (int8)
  float* vsc = ksc + BK;                        // [BK]
  __shared__ int qps[BQ], kps[BK], qmax_s;
  const int q0 = blockIdx.x * BQ, n = blockIdx.y, b = blockIdx.z;
  const int kv = n / (a.Nq / a.Kv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long qstride = static_cast<long long>(a.Nq) * H;
  const QT* qb = static_cast<const QT*>(a.q) +
                 (static_cast<long long>(b) * a.T * a.Nq + n) * H;
  load_rows<H, BQ>(qs, qb, qstride, q0, a.T);
  const int qmax = stage_qpos(a, b, q0, qps, &qmax_s);

  State<H> st;
  init_state(st);
  const float scale = 1.0f / sqrtf(static_cast<float>(H));
  const Block<KT> blk = block_of<KT, QUANT>(a, b, kv);
  for (int c0 = 0; c0 < a.S; c0 += BK) {
    if (!stage_kpos(a, b, c0, qmax, kps)) continue;  // block-uniform
    fold_tile<H, KT, QUANT, true>(qs, kvs, ps, ksc, vsc, blk.kb, blk.vb,
                                  a.kss, c0, a.S, blk.ksg, blk.vsg, false, 0,
                                  qps, kps, scale, st);
  }

  const long long rbase = (static_cast<long long>(b) * a.Nq + n) * a.T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < a.T) {
      if (tx == 0) {
        // a row no tile reached still holds -inf: report the finite NEG
        a.m[rbase + row] = fmaxf(st.m[i], NEG);
        a.l[rbase + row] = st.l[i];
      }
      float* ar = a.acc + (rbase + row) * H;
#pragma unroll
      for (int j = 0; j < NJ; ++j) ar[tx + 16 * j] = st.o[i][j];
    }
  }
}

template <typename QT, typename KT, int H, bool QUANT>
int launch(const RingArgs& a, int B, cudaStream_t stream) {
  constexpr int LD = H + 4;
  const size_t bytes =
      (static_cast<size_t>(BQ + BK) * LD + BQ * LDP + 2 * BK) * sizeof(float);
  auto kern = ring_kernel<QT, KT, H, QUANT>;
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  const dim3 grid((a.T + BQ - 1) / BQ, a.Nq, B);
  kern<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// T = 1: the split-over-keys decode kernels and their merge
// ---------------------------------------------------------------------------

constexpr float LN2 = 0.6931471805599453f;
constexpr int DW = 4;        // warps per decode block
constexpr int DCH = 16;      // keys per chunk (the MMA's M)
constexpr int DSTAGES = 3;   // chunks in a warp's ring
constexpr int HG = 8;        // query heads per decode block (the MMA's N)

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wg::smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wg::smem_u32(p)));
}
// transpose of an 8 x 8 b16 matrix held as one fragment register per lane
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// The decode block's place: split sp of keys [c_lo, c_hi), query heads
// h0 .. h0 + nh - 1 of kv head kv, batch row b.
struct DecBlock {
  int sp, kv, h0, nh, b, c_lo, c_hi;
};

__device__ __forceinline__ DecBlock dec_block(const RingArgs& a) {
  const int G = a.Nq / a.Kv, NG = (G + HG - 1) / HG;
  DecBlock d;
  d.sp = blockIdx.x;
  d.kv = blockIdx.y / NG;
  const int hg = blockIdx.y - d.kv * NG;
  d.h0 = d.kv * G + hg * HG;
  d.nh = min(HG, G - hg * HG);
  d.b = blockIdx.z;
  d.c_lo = d.sp * a.split;
  d.c_hi = min(a.S, d.c_lo + a.split);
  return d;
}

// Merge the DW warps' states (m in base-2 units, heads strided by HG) in
// shared memory into the block's partial: the raw (m, l, acc) of its rows
// when there is one split, else the split's slot of the workspace. The
// caller syncs first.
template <int H>
__device__ void write_split(const RingArgs& a, const DecBlock& d,
                            const float* wm, const float* wl,
                            const float* wacc) {
  const long long N = static_cast<long long>(gridDim.z) * a.Nq * a.n_split;
  for (int i = threadIdx.x; i < d.nh * H; i += blockDim.x) {
    const int gg = i / H, h = i - gg * H;
    float M = NEG;
    for (int w = 0; w < DW; ++w) M = fmaxf(M, wm[w * HG + gg]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < DW; ++w) {
      const float f = exp2f(wm[w * HG + gg] - M);
      L = fmaf(wl[w * HG + gg], f, L);
      A = fmaf(wacc[(w * HG + gg) * H + h], f, A);
    }
    const long long row = static_cast<long long>(d.b) * a.Nq + d.h0 + gg;
    if (a.n_split == 1) {
      a.acc[row * H + h] = A;
      if (h == 0) {
        a.m[row] = M <= NEG ? NEG : M * LN2;  // natural units
        a.l[row] = L;
      }
    } else {
      const long long p = row * a.n_split + d.sp;
      a.ws[p * H + h] = A;
      if (h == 0) {
        a.ws[N * H + p] = M;
        a.ws[N * H + N + p] = L;
      }
    }
  }
}

// Shared memory of one warp of the tensor-core decode kernel, in bytes:
// DSTAGES stages of [K rows | V rows] (DCH rows of H KT elements, padded
// by 16 bytes so ldmatrix's 8 row reads hit different banks) + DCH K
// scales, V scales and key positions; for int8 one widened [K | V] tile
// of DCH x (H + 8) bf16.
template <typename KT, int H>
struct DecSmem {
  static constexpr int ROW = H * static_cast<int>(sizeof(KT)) + 16;
  static constexpr int STAGE = 2 * DCH * ROW + 3 * DCH * 4;
  static constexpr bool QUANT = sizeof(KT) == 1;
  static constexpr int WIDE_ROW = (H + 8) * 2;
  static constexpr int WIDE = QUANT ? 2 * DCH * WIDE_ROW : 0;
  static constexpr int WARP = DSTAGES * STAGE + WIDE;
};

// widen 16 int8 codes to 16 T (bf16 or f16; two 16-byte stores)
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

// bf16 / f16 queries (T) on the tensor cores, K/V of type T or int8 codes
// (KT). Fragment layouts are the PTX ISA's for m16n8k16 (lane g =
// lane / 4, t = lane % 4).
template <typename T, typename KT, int H>
__global__ void __launch_bounds__(DW * 32) ring_decode_tc_kernel(RingArgs a) {
  using L = DecSmem<KT, H>;
  constexpr bool QUANT = L::QUANT;
  constexpr int PR = H * static_cast<int>(sizeof(KT)) / 16;  // 16 B / row
  extern __shared__ uint4 smem_dec[];
  const DecBlock d = dec_block(a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* wbase = reinterpret_cast<uint8_t*>(smem_dec) + warp * L::WARP;

  // the group's queries as B fragments (head h0 + g on N)
  uint32_t qb[H / 16][2];
  {
    const T* qrow = static_cast<const T*>(a.q) +
                    (static_cast<long long>(d.b) * a.Nq + d.h0 + g) * H;
    const bool live = g < d.nh;
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      qb[kk][0] = live ? *reinterpret_cast<const uint32_t*>(
                             qrow + kk * 16 + 2 * t) : 0u;
      qb[kk][1] = live ? *reinterpret_cast<const uint32_t*>(
                             qrow + kk * 16 + 8 + 2 * t) : 0u;
    }
  }
  const int qp = a.qpos[d.b];  // T = 1
  const float scale = rsqrtf(static_cast<float>(H)) * wg::LOG2E;
  const Block<KT> blk = block_of<KT, QUANT>(a, d.b, d.kv);
  const int* kpg = a.kpos + static_cast<long long>(d.b) * a.S;

  const int n_chunks = (d.c_hi - d.c_lo + DCH - 1) / DCH;
  const int mine = warp < n_chunks ? (n_chunks - warp + DW - 1) / DW : 0;

  // issue chunk i of this warp into stage i % DSTAGES
  auto issue = [&](int i) {
    const int c0 = d.c_lo + (warp + i * DW) * DCH;
    uint8_t* st = wbase + (i % DSTAGES) * L::STAGE;
#pragma unroll
    for (int e = lane; e < 2 * DCH * PR; e += 32) {
      const int kvsel = e / (DCH * PR);
      const int r = (e - kvsel * DCH * PR) / PR;
      const int pc = e - kvsel * DCH * PR - r * PR;
      const bool ok = c0 + r < d.c_hi;
      const KT* src = (kvsel ? blk.vb : blk.kb) +
                      (ok ? c0 + r : 0) * a.kss + pc * (16 / sizeof(KT));
      wg::cp_async16(st + (kvsel * DCH + r) * L::ROW + pc * 16, src, ok);
    }
    float* scs = reinterpret_cast<float*>(st + 2 * DCH * L::ROW);
    const int r = lane & (DCH - 1);
    const bool ok = c0 + r < d.c_hi;
    const int cr = ok ? c0 + r : d.c_lo;
    if constexpr (QUANT)  // K scales (lanes 0-15), V scales (16-31)
      cp_async4(scs + lane, (lane < DCH ? blk.ksg : blk.vsg) + cr, ok);
    if (lane < DCH)  // key positions (a row past c_hi is masked by index)
      cp_async4(scs + 2 * DCH + lane, kpg + cr, ok);
  };

  float acc[H / 16][4];
#pragma unroll
  for (int j = 0; j < H / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG, NEG};     // heads 2t, 2t + 1 (base-2 units)
  float lsum[2] = {0.f, 0.f};  // this lane's keys' share of l

#pragma unroll
  for (int i = 0; i < DSTAGES - 1; ++i) {
    if (i < mine) issue(i);
    wg::cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + DSTAGES - 1 < mine) issue(i + DSTAGES - 1);
    wg::cp_async_commit();
    wg::cp_async_wait<DSTAGES - 1>();
    __syncwarp();
    const uint8_t* st = wbase + (i % DSTAGES) * L::STAGE;
    const int c0 = d.c_lo + (warp + i * DW) * DCH;
    const uint8_t* kt = st;
    const uint8_t* vt = st + DCH * L::ROW;
    int ld = L::ROW;  // bytes per tile row
    if constexpr (QUANT) {
      uint16_t* wide =
          reinterpret_cast<uint16_t*>(wbase + DSTAGES * L::STAGE);
      for (int e = lane; e < 2 * DCH * (H / 16); e += 32) {
        const int r = e / (H / 16), c = (e - r * (H / 16)) * 16;
        widen16<T>(wide + r * (H + 8) + c,
                reinterpret_cast<const int8_t*>(st + r * L::ROW) + c);
      }
      __syncwarp();
      kt = reinterpret_cast<const uint8_t*>(wide);
      vt = kt + DCH * L::WIDE_ROW;
      ld = L::WIDE_ROW;
    }
    // scores: [16 keys] x [8 heads]
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
    const float* scs = reinterpret_cast<const float*>(st + 2 * DCH * L::ROW);
    const int* kps = reinterpret_cast<const int*>(scs + 2 * DCH);
    const bool ok0 = c0 + g < d.c_hi && kps[g] <= qp;
    const bool ok1 = c0 + g + 8 < d.c_hi && kps[g + 8] <= qp;
    float ks0 = 1.f, ks1 = 1.f, vs0 = 1.f, vs1 = 1.f;
    if constexpr (QUANT) {
      ks0 = scs[g];
      ks1 = scs[g + 8];
      vs0 = scs[DCH + g];
      vs1 = scs[DCH + g + 8];
    }
    // keys g (sc[0], sc[1]) and g + 8 (sc[2], sc[3]); heads 2t, 2t + 1
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
    // P^T as the B operand: keys on K, heads on N
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
  wg::cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lsum[e] += __shfl_xor_sync(FULL, lsum[e], 4);
    lsum[e] += __shfl_xor_sync(FULL, lsum[e], 8);
    lsum[e] += __shfl_xor_sync(FULL, lsum[e], 16);
  }
  __syncthreads();  // every warp done with its stages: reuse them
  float* wm = reinterpret_cast<float*>(smem_dec);  // [DW][HG]
  float* wl = wm + DW * HG;                        // [DW][HG]
  float* wacc = wl + DW * HG;                      // [DW][HG][H]
  if (g == 0) {
    wm[warp * HG + 2 * t] = m[0];
    wm[warp * HG + 2 * t + 1] = m[1];
    wl[warp * HG + 2 * t] = lsum[0];
    wl[warp * HG + 2 * t + 1] = lsum[1];
  }
  // acc[j]: rows h = 16j + g (+ 8), columns heads 2t, 2t + 1
#pragma unroll
  for (int j = 0; j < H / 16; ++j) {
    float* w0 = wacc + (warp * HG + 2 * t) * H + 16 * j + g;
    w0[0] = acc[j][0];
    w0[H] = acc[j][1];
    w0[8] = acc[j][2];
    w0[H + 8] = acc[j][3];
  }
  __syncthreads();
  write_split<H>(a, d, wm, wl, wacc);
}

// Queries of type QT (f32, bf16, f16) on the CUDA cores in f32, under the
// same grid: each warp folds every DW-th key of the split into the block's
// HG heads, a lane holding VPL consecutive elements of each head's query
// and accumulator (at H = 16 the upper 16 lanes hold none), dots reduced
// across the warp. A masked key is skipped whole (warp-uniform).
template <typename QT, typename KT, int H>
__global__ void __launch_bounds__(DW * 32) ring_decode_cc_kernel(RingArgs a) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int VPL = (H + 31) / 32;  // elements per lane
  extern __shared__ uint4 smem_dec[];
  const DecBlock d = dec_block(a);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qp = a.qpos[d.b];
  const float scale = rsqrtf(static_cast<float>(H)) * wg::LOG2E;
  const Block<KT> blk = block_of<KT, QUANT>(a, d.b, d.kv);
  const int* kpg = a.kpos + static_cast<long long>(d.b) * a.S;
  float qv[HG][VPL], acc[HG][VPL], m[HG], l[HG];
#pragma unroll
  for (int gg = 0; gg < HG; ++gg) {
    const QT* qr = static_cast<const QT*>(a.q) +
                   (static_cast<long long>(d.b) * a.Nq + d.h0 + gg) * H;
#pragma unroll
    for (int e = 0; e < VPL; ++e) {
      qv[gg][e] = gg < d.nh && lane * VPL + e < H ? to_f(qr[lane * VPL + e])
                                                  : 0.f;
      acc[gg][e] = 0.f;
    }
    m[gg] = NEG;
    l[gg] = 0.f;
  }
  for (int c = d.c_lo + warp; c < d.c_hi; c += DW) {
    if (kpg[c] > qp) continue;  // masked: contributes exactly nothing
    const KT* kr = blk.kb + c * a.kss + lane * VPL;
    const KT* vr = blk.vb + c * a.kss + lane * VPL;
    float kf[VPL], vf[VPL];
#pragma unroll
    for (int e = 0; e < VPL; ++e) {
      const bool in = lane * VPL + e < H;
      kf[e] = in ? to_f(kr[e]) : 0.f;
      vf[e] = in ? to_f(vr[e]) : 0.f;
    }
    const float ksc = QUANT ? blk.ksg[c] : 1.f;
    const float vsc = QUANT ? blk.vsg[c] : 1.f;
#pragma unroll
    for (int gg = 0; gg < HG; ++gg) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VPL; ++e) s = fmaf(qv[gg][e], kf[e], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(FULL, s, off);
      s = s * ksc * scale;  // K scale, then log2(e) / sqrt(H)
      const float m_new = fmaxf(m[gg], s);
      const float corr = exp2f(m[gg] - m_new);
      const float p = exp2f(s - m_new);
      l[gg] = l[gg] * corr + p;
      const float pv = p * vsc;  // the V scale, after p entered l
#pragma unroll
      for (int e = 0; e < VPL; ++e)
        acc[gg][e] = fmaf(pv, vf[e], acc[gg][e] * corr);
      m[gg] = m_new;
    }
  }
  float* wm = reinterpret_cast<float*>(smem_dec);  // [DW][HG]
  float* wl = wm + DW * HG;                        // [DW][HG]
  float* wacc = wl + DW * HG;                      // [DW][HG][H]
#pragma unroll
  for (int gg = 0; gg < HG; ++gg) {
    if (lane == 0) {
      wm[warp * HG + gg] = m[gg];
      wl[warp * HG + gg] = l[gg];
    }
#pragma unroll
    for (int e = 0; e < VPL; ++e)
      if (lane * VPL + e < H)
        wacc[(warp * HG + gg) * H + lane * VPL + e] = acc[gg][e];
  }
  __syncthreads();
  write_split<H>(a, d, wm, wl, wacc);
}

// One block per (query head, batch row): the row's split partials merged
// in split order into the raw (m, l, acc): M = max m_i, l = sum l_i
// 2^(m_i - M), acc = sum acc_i 2^(m_i - M), m = M in natural units (the
// exact -1e30 when no split saw a live key).
template <int H>
__global__ void __launch_bounds__(128) ring_merge_kernel(RingArgs a) {
  const int n = blockIdx.x, b = blockIdx.y;
  const long long N = static_cast<long long>(gridDim.y) * a.Nq * a.n_split;
  const long long row = static_cast<long long>(b) * a.Nq + n;
  const long long p0 = row * a.n_split;
  const float* acc = a.ws + p0 * H;
  const float* m = a.ws + N * H + p0;
  const float* l = m + N;
  float M = NEG;
  for (int k = 0; k < a.n_split; ++k) M = fmaxf(M, m[k]);
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float A = 0.f;
    for (int k = 0; k < a.n_split; ++k)
      A = fmaf(acc[static_cast<long long>(k) * H + h], exp2f(m[k] - M), A);
    a.acc[row * H + h] = A;
  }
  if (threadIdx.x == 0) {
    float Ls = 0.f;
    for (int k = 0; k < a.n_split; ++k) Ls = fmaf(l[k], exp2f(m[k] - M), Ls);
    a.l[row] = Ls;
    a.m[row] = M <= NEG ? NEG : M * LN2;
  }
}

// CC: the CUDA-core kernel, else the tensor-core one (QT bf16 / f16)
template <typename QT, typename KT, int H, bool CC>
int launch_decode(const RingArgs& a, int B, cudaStream_t stream) {
  const int G = a.Nq / a.Kv;
  const dim3 grid(a.n_split, a.Kv * ((G + HG - 1) / HG), B);
  const size_t merge_bytes = (2 * DW * HG + DW * HG * H) * sizeof(float);
  if constexpr (CC) {
    auto kern = ring_decode_cc_kernel<QT, KT, H>;
    kern<<<grid, DW * 32, merge_bytes, stream>>>(a);
  } else {
    const size_t bytes = static_cast<size_t>(DW) * DecSmem<KT, H>::WARP;
    auto kern = ring_decode_tc_kernel<QT, KT, H>;
    const int e = allow_smem(kern, bytes);
    if (e != 0) return e;
    kern<<<grid, DW * 32, bytes, stream>>>(a);
  }
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0 || a.n_split == 1) return e;
  ring_merge_kernel<H><<<dim3(a.Nq, B), 128, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// T > 1, bf16 / f16: the warpgroup-MMA block kernel
// ---------------------------------------------------------------------------

// Shared memory of ring_wg_kernel beyond the 1024-byte alignment pad: the
// Q tile; bf16 K/V: STAGES swizzled stages; int8: STAGES raw stages, one
// widened tile and the tile's scales; then nk key tiles' smallest and
// largest positions and the list of live tiles.
template <typename KT, int H>
struct WgSmem {
  static constexpr bool QUANT = sizeof(KT) == 1;
  static constexpr int Q_BYTES = wg::BQ * H * 2;
  static constexpr int KV_BYTES = wg::BKW * H * 2;
  static constexpr int RAW_BYTES = wg::BKW * H;
  static constexpr int TILES = (QUANT ? 1 : wg::STAGES) * 2 * KV_BYTES;
  static constexpr int RAW = QUANT ? wg::STAGES * 2 * RAW_BYTES : 0;
  static constexpr int FIXED = Q_BYTES + TILES + RAW + 2 * wg::BKW * 4;
  static size_t bytes(int nk) { return 1024 + FIXED + 3 * 4 * nk; }
};

// Two blocks per SM, as the fresh wgmma kernel: at H = 128 that caps a
// thread at 128 registers (80 bytes spill; one block would take 143).
template <typename T, typename KT, int H>
__global__ void __launch_bounds__(wg::NTHREADS, 2) ring_wg_kernel(RingArgs a) {
  using namespace wg;
  constexpr int BQ = wg::BQ;  // not flash_tiles.cuh's 64-row bt::BQ
  using L = WgSmem<KT, H>;
  constexpr bool QUANT = L::QUANT;
  constexpr int C16 = H / 8;   // 16-byte chunks per row (bf16 / f16)
  constexpr int R16 = H / 16;  // 16-byte chunks per row (int8)
  constexpr int NS = BKW / 2;  // score accumulators per thread
  extern __shared__ __align__(128) uint8_t wg_smem[];
  const uint32_t pad = (1024u - (smem_u32(wg_smem) & 1023u)) & 1023u;
  const int nk = (a.S + BKW - 1) / BKW;
  uint8_t* qs = wg_smem + pad;                // [H/64][BQ][128 B]
  uint8_t* ks = qs + L::Q_BYTES;              // bf16: [STAGES] tiles
  uint8_t* vs = ks + L::TILES / 2;            // int8: the widened tile
  int8_t* kraw = reinterpret_cast<int8_t*>(vs + L::TILES / 2);
  int8_t* vraw = kraw + L::RAW / 2;           // [STAGES][BKW][H] (int8)
  float* ksc = reinterpret_cast<float*>(vraw + L::RAW / 2);
  float* vsc = ksc + BKW;                     // [BKW] scales (int8)
  int* tmin = reinterpret_cast<int*>(vsc + BKW);  // [nk]
  int* tmax = tmin + nk;                          // [nk]
  int* live = tmax + nk;                          // [nlive]
  __shared__ int wq[4];  // warpgroup 0 min, max; warpgroup 1 min, max
  __shared__ int nlive_s;

  // heads fastest (a kv group's G heads adjacent); last query tile first
  const int ntiles = (a.T + BQ - 1) / BQ;
  int bid = blockIdx.x;
  const int n = bid % a.Nq;
  bid /= a.Nq;
  const int q0 = (ntiles - 1 - bid % ntiles) * BQ;
  const int b = bid / ntiles;
  const int kv = n / (a.Nq / a.Kv);
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qstride = static_cast<long long>(a.Nq) * H;
  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<long long>(b) * a.T * a.Nq + n) * H;
  const Block<KT> blk = block_of<KT, QUANT>(a, b, kv);
  const int* kpg = a.kpos + static_cast<long long>(b) * a.S;

  for (int e = tid; e < BQ * C16; e += NTHREADS) {
    const int r = e / C16, ch = e - r * C16;
    const bool ok = q0 + r < a.T;
    cp_async16(qs + swz<BQ>(r, ch),
               qb + (ok ? q0 + r : 0) * qstride + ch * 8, ok);
  }

  // this thread's rows and their positions (INT_MIN past T: never live)
  if (tid < 4) wq[tid] = (tid & 1) ? INT_MIN : INT_MAX;
  const int r0 = q0 + wgi * 64;  // the warpgroup's first query row
  const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;
  const int* qpg = a.qpos + static_cast<long long>(b) * a.T;
  const int qpa = row_a < a.T ? qpg[row_a] : INT_MIN;
  const int qpb = row_b < a.T ? qpg[row_b] : INT_MIN;
  __syncthreads();  // wq initialised
  {
    int mn = min(row_a < a.T ? qpa : INT_MAX, row_b < a.T ? qpb : INT_MAX);
    int mx = max(qpa, qpb);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(FULL, mn, off));
      mx = max(mx, __shfl_xor_sync(FULL, mx, off));
    }
    if (lane == 0) {
      atomicMin(&wq[2 * wgi], mn);
      atomicMax(&wq[2 * wgi + 1], mx);
    }
  }
  // every key tile's smallest and largest position (keys past S invalid)
  for (int tile = tid >> 5; tile < nk; tile += NTHREADS / 32) {
    const int c = tile * BKW + lane;
    const int p0 = c < a.S ? kpg[c] : INT_MAX;
    const int p1 = c + 32 < a.S ? kpg[c + 32] : INT_MAX;
    int mn = min(p0, p1), mx = max(p0, p1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(FULL, mn, off));
      mx = max(mx, __shfl_xor_sync(FULL, mx, off));
    }
    if (lane == 0) {
      tmin[tile] = mn;
      tmax[tile] = mx;
    }
  }
  __syncthreads();
  const int qmin = wq[2 * wgi], qmax = wq[2 * wgi + 1];
  if (tid < 32) {  // the tiles some row of the block sees, in order
    const int qmax_blk = max(wq[1], wq[3]);
    int cnt = 0;
    for (int base = 0; base < nk; base += 32) {
      const int tile = base + lane;
      const bool lv = tile < nk && tmin[tile] <= qmax_blk;
      const unsigned bal = __ballot_sync(FULL, lv);
      if (lv) live[cnt + __popc(bal & ((1u << lane) - 1u))] = tile;
      cnt += __popc(bal);
    }
    if (lane == 0) nlive_s = cnt;
  }
  __syncthreads();
  const int nl = nlive_s;

  auto load_kv = [&](int i) {
    const int c0 = live[i] * BKW;
    const int st = i % STAGES;
    if constexpr (QUANT) {
      for (int e = tid; e < BKW * R16; e += NTHREADS) {
        const int r = e / R16, ch = e - r * R16;
        const bool ok = c0 + r < a.S;
        const long long off = (ok ? c0 + r : 0) * a.kss + ch * 16;
        cp_async16(kraw + st * L::RAW_BYTES + r * H + ch * 16, blk.kb + off,
                   ok);
        cp_async16(vraw + st * L::RAW_BYTES + r * H + ch * 16, blk.vb + off,
                   ok);
      }
    } else {
      for (int e = tid; e < BKW * C16; e += NTHREADS) {
        const int r = e / C16, ch = e - r * C16;
        const bool ok = c0 + r < a.S;
        const long long off = (ok ? c0 + r : 0) * a.kss + ch * 8;
        cp_async16(ks + st * L::KV_BYTES + swz<BKW>(r, ch), blk.kb + off, ok);
        cp_async16(vs + st * L::KV_BYTES + swz<BKW>(r, ch), blk.vb + off, ok);
      }
    }
  };
  if (nl > 0) load_kv(0);  // Q rides in the first group
  cp_async_commit();

  float o[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // raw score units
  float l[2] = {0.f, 0.f};  // this lane's share of rows a, b's denominators
  const float scale2 = rsqrtf(static_cast<float>(H)) * LOG2E;
  const uint32_t qaddr = smem_u32(qs) + wgi * 64 * 128;

  for (int i = 0; i < nl; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i landed
    fence_proxy_async();
    __syncthreads();  // tile i staged by all; tile i - 1's stage is free
    if (i + STAGES - 1 < nl) load_kv(i + STAGES - 1);
    cp_async_commit();
    const int tile = live[i], c0 = tile * BKW;
    uint8_t* kt = ks + (QUANT ? 0 : (i % STAGES) * L::KV_BYTES);
    uint8_t* vt = vs + (QUANT ? 0 : (i % STAGES) * L::KV_BYTES);
    if constexpr (QUANT) {  // widen the raw codes; stage the scales
      widen_tile<T, H, BKW>(kt, kraw + (i % STAGES) * L::RAW_BYTES);
      widen_tile<T, H, BKW>(vt, vraw + (i % STAGES) * L::RAW_BYTES);
      if (tid < 2 * BKW) {
        const int c = c0 + (tid & (BKW - 1));
        const float* src = tid < BKW ? blk.ksg : blk.vsg;
        (tid < BKW ? ksc : vsc)[tid & (BKW - 1)] = c < a.S ? src[c] : 0.f;
      }
      fence_proxy_async();
      __syncthreads();
    }
    if (tmin[tile] <= qmax) {  // some pair of this warpgroup lives
      const uint32_t kaddr = smem_u32(kt);
      const uint32_t vaddr = smem_u32(vt);
      float s[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) s[k] = 0.f;
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
      if constexpr (QUANT) {  // the K scale, before the max
#pragma unroll
        for (int k = 0; k < NS; ++k)
          s[k] *= ksc[8 * (k >> 2) + 2 * t + (k & 1)];
      }
      // masked only where some pair is: positions cross, or some key is
      // invalid or past S (its tile's largest position is then INT_MAX)
      const bool masked = tmax[tile] > qmin;
      uint32_t okb = 0xffffffffu;
      if (masked) {
        okb = 0u;
#pragma unroll
        for (int jj = 0; jj < BKW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + jj * 8 + 2 * t + e;
            const int kp = col < a.S ? kpg[col] : INT_MAX;
            const int ka = 4 * jj + e, kb2 = ka + 2;
            if (kp <= qpa) okb |= 1u << ka; else s[ka] = NEG;
            if (kp <= qpb) okb |= 1u << kb2; else s[kb2] = NEG;
          }
      }
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
      // p = 2^(s * log2(e) / sqrt(H) - m'); a masked pair is exactly 0
      // (a row may have no live key yet, so the select is explicit)
#pragma unroll
      for (int k = 0; k < NS; ++k)
        s[k] = fast_exp2(fmaf(s[k], scale2, -ms[(k >> 1) & 1]));
      if (masked) {
#pragma unroll
        for (int k = 0; k < NS; ++k) s[k] = (okb >> k) & 1u ? s[k] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = l[h] * corr[h] + row_reduce<BKW, false>(s, h);
#pragma unroll
      for (int k = 0; k < H / 2; ++k) o[k] *= corr[(k >> 1) & 1];
      if constexpr (QUANT) {  // the V scale, after l summed the probability
#pragma unroll
        for (int k = 0; k < NS; ++k)
          s[k] *= vsc[8 * (k >> 2) + 2 * t + (k & 1)];
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
  cp_async_wait<0>();

  // raw stats: m in natural units (the exact -1e30 for a row that saw no
  // live key), l reduced across the quad, acc unnormalised
  const float scale = rsqrtf(static_cast<float>(H));
  const long long rbase = (static_cast<long long>(b) * a.Nq + n) * a.T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    const int row = h ? row_b : row_a;
    if (row < a.T) {
      if (t == 0) {
        a.m[rbase + row] = m[h] <= NEG ? NEG : m[h] * scale;
        a.l[rbase + row] = l[h];
      }
      float* ar = a.acc + (rbase + row) * H;
#pragma unroll
      for (int jj = 0; jj < H / 8; ++jj)
        *reinterpret_cast<float2*>(ar + jj * 8 + 2 * t) =
            make_float2(o[4 * jj + 2 * h], o[4 * jj + 2 * h + 1]);
    }
  }
}

template <typename T, typename KT, int H>
int launch_wg(const RingArgs& a, int B, cudaStream_t stream) {
  const int nk = (a.S + wg::BKW - 1) / wg::BKW;
  const size_t bytes = WgSmem<KT, H>::bytes(nk);
  if (bytes > 227 * 1024) return -2;  // S too long for the tile table
  auto kern = ring_wg_kernel<T, KT, H>;
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  const int ntiles = (a.T + wg::BQ - 1) / wg::BQ;
  kern<<<ntiles * a.Nq * B, wg::NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core kernels take bf16 / f16 at these head dims
template <int H>
constexpr bool kTensorCores = H == 64 || H == 128;

template <typename T, int H>
int launch_t(bool quant, const RingArgs& a, int B, cudaStream_t s) {
  if constexpr (kTensorCores<H>)
    return quant ? launch_wg<T, int8_t, H>(a, B, s)
                 : launch_wg<T, T, H>(a, B, s);
  else
    return quant ? launch<T, int8_t, H, true>(a, B, s)
                 : launch<T, T, H, false>(a, B, s);
}

template <int H>
int launch_h(int dtype, bool quant, const RingArgs& a, int B,
             cudaStream_t s) {
  switch (dtype) {
    case 0:
      return quant ? launch<float, int8_t, H, true>(a, B, s)
                   : launch<float, float, H, false>(a, B, s);
    case 1: return launch_t<__half, H>(quant, a, B, s);
    case 2: return launch_t<__nv_bfloat16, H>(quant, a, B, s);
    default: return -1;
  }
}

template <typename T, int H>
int launch_decode_t(bool quant, const RingArgs& a, int B, cudaStream_t s) {
  constexpr bool CC = !kTensorCores<H>;
  return quant ? launch_decode<T, int8_t, H, CC>(a, B, s)
               : launch_decode<T, T, H, CC>(a, B, s);
}

template <int H>
int launch_decode_h(int dtype, bool quant, const RingArgs& a, int B,
                    cudaStream_t s) {
  switch (dtype) {
    case 0:
      return quant ? launch_decode<float, int8_t, H, true>(a, B, s)
                   : launch_decode<float, float, H, true>(a, B, s);
    case 1: return launch_decode_t<__half, H>(quant, a, B, s);
    case 2: return launch_decode_t<__nv_bfloat16, H>(quant, a, B, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, for q and float k/v;
// quant != 0: k/v are int8 codes with f32 scales ks/vs [B, Kv, S]
// (contiguous). Head dims 16, 32, 64, 128, 256. q [B, T, Nq, H], qpos
// [B, T], kpos [B, S], m/l [B, Nq, T] and acc [B, Nq, T, H] contiguous;
// k/v rows (b, c, kv) at element offsets b*ksb + c*kss + kv*ksh with a
// contiguous last dim (for int8, strides multiples of 16 bytes). Returns
// 0 on success, -1 for an unsupported dtype or head_dim, -2 when S is too
// long for the wgmma kernel's tile table, else the cudaError_t of the
// launch.
extern "C" int bt_ring_stats(int dtype, int quant, const void* q,
                             const void* k, const void* v, const float* ks,
                             const float* vs, const int* qpos,
                             const int* kpos, float* m, float* l, float* acc,
                             int B, int T, int S, int Nq, int Kv, int H,
                             long long ksb, long long kss, long long ksh,
                             void* stream) {
  const RingArgs a{q, k, v, ks, vs, qpos, kpos, m, l, acc, nullptr,
                   ksb, kss, ksh, T, S, Nq, Kv, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 16: return launch_h<16>(dtype, quant != 0, a, B, s);
    case 32: return launch_h<32>(dtype, quant != 0, a, B, s);
    case 64: return launch_h<64>(dtype, quant != 0, a, B, s);
    case 128: return launch_h<128>(dtype, quant != 0, a, B, s);
    case 256: return launch_h<256>(dtype, quant != 0, a, B, s);
    default: return -1;
  }
}

// T = 1 (a decode step): as bt_ring_stats with T = 1, split over the keys
// by ops/ring_attention.py:ring_split_plan (split keys a block, n_split
// splits); ws: f32 workspace of B * Nq * n_split * (H + 2) floats, unused
// when n_split == 1.
extern "C" int bt_ring_decode(int dtype, int quant, const void* q,
                              const void* k, const void* v, const float* ks,
                              const float* vs, const int* qpos,
                              const int* kpos, float* m, float* l,
                              float* acc, float* ws, int B, int S, int Nq,
                              int Kv, int H, long long ksb, long long kss,
                              long long ksh, int split, int n_split,
                              void* stream) {
  const RingArgs a{q, k, v, ks, vs, qpos, kpos, m, l, acc, ws,
                   ksb, kss, ksh, 1, S, Nq, Kv, split, n_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 16: return launch_decode_h<16>(dtype, quant != 0, a, B, s);
    case 32: return launch_decode_h<32>(dtype, quant != 0, a, B, s);
    case 64: return launch_decode_h<64>(dtype, quant != 0, a, B, s);
    case 128: return launch_decode_h<128>(dtype, quant != 0, a, B, s);
    case 256: return launch_decode_h<256>(dtype, quant != 0, a, B, s);
    default: return -1;
  }
}
