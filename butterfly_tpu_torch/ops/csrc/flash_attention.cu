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
// * fresh bf16 / f16 at the main path's head dims (Llama-3-8B H = 128,
//   GPT-2 H = 64) run on Hopper's warpgroup MMA: 128-row blocks of two
//   warpgroups, wgmma for Q.K^T and P.V, K/V tiles streamed through a
//   cp.async ring, a kv group's query heads in adjacent blocks, causal
//   tiles heaviest first (flash_fresh_wg_kernel in flash_wgmma.cuh).
// * warm bf16 / f16 at head dims up to 128, and fresh at H = 16 / 32, run
//   on the tensor cores through mma.sync: 4 warps of 16 query rows each,
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
// The tile machinery (loads, fold_tile, fold_tile_mma) lives in
// flash_tiles.cuh, shared with the ring-attention kernel; the wgmma
// kernel has its own header and shares none of it but the small helpers.
// Not yet done (a later change): the warm kernel on wgmma, reading the
// pool's pages through the block table; TMA and a producer warp for the
// fresh kernel.

#include "flash_tiles.cuh"
#include "flash_wgmma.cuh"

#include <type_traits>

namespace {

using namespace bt;

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
  init_state(st);
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
                              plen, ksg, vsg, false, q0, nullptr, nullptr,
                              scale, st);
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
                           nullptr, nullptr, causal, q0, nullptr, nullptr,
                           scale, st);

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
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  const dim3 grid((a.T + BQ - 1) / BQ, a.Nq, B);
  kern<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Tensor-core path: bf16 / f16 queries, head dims 16..128 (see the note
// at the top and flash_tiles.cuh).
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
  load_q_frags<H>(qs, qa);

  MmaState<H> st;
  init_state(st);
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
                                     c0, plen, ksg, vsg, false, row0,
                                     nullptr, nullptr, scale, st);
  }
  const bool causal = WARM || a.causal != 0;
  const int kend = causal ? min(a.T, q0 + BQ) : a.T;
  const long long koff = static_cast<long long>(b) * a.T * a.Kv + kv;
  const T* kb = static_cast<const T*>(a.k) + koff * H;
  const T* vb = static_cast<const T*>(a.v) + koff * H;
  for (int c0 = 0; c0 < kend; c0 += BK)
    fold_tile_mma<T, H, T, false>(qa, ks, vs, ksc, vsc, kb, vb, kstride, c0,
                                  a.T, nullptr, nullptr, causal, row0,
                                  nullptr, nullptr, scale, st);

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
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  const dim3 grid((a.T + BQ - 1) / BQ, a.Nq, B);
  kern<<<grid, NT_MMA, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int H>
int launch_wg(const Args& a, int B, cudaStream_t s) {
  const wg::FreshArgs f{a.q, a.k, a.v, a.out, a.T, a.Nq, a.Kv, a.causal,
                        (a.T + wg::BQ - 1) / wg::BQ};
  return wg::launch_fresh_wg<T, H>(f, B, s);
}

// f32 takes the CUDA-core kernel at every head dim; bf16 and f16 take the
// wgmma kernel for fresh chunks at H = 64 and 128, the mma.sync kernel
// otherwise up to H = 128 (at H = 256 its accumulators alone would need
// 128 registers a thread) and the CUDA-core one above.
template <typename T, typename PT, bool WARM, bool QUANT>
int launch_h(const Args& a, int B, int H, cudaStream_t s) {
  if constexpr (!WARM && !std::is_same<T, float>::value) {
    switch (H) {
      case 16: return launch_mma<T, PT, 16, WARM, QUANT>(a, B, s);
      case 32: return launch_mma<T, PT, 32, WARM, QUANT>(a, B, s);
      case 64: return launch_wg<T, 64>(a, B, s);
      case 128: return launch_wg<T, 128>(a, B, s);
      case 256: return launch<T, PT, 256, WARM, QUANT>(a, B, s);
      default: return -1;
    }
  } else if constexpr (std::is_same<T, float>::value) {
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
