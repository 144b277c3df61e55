// Ring-attention block kernel for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel _ring_kernel of
// butterfly_tpu/ops/ring_attention.py (:158, its pallas_call at :259): the
// UNNORMALISED partial flash statistics of one K/V block,
//   m [B, Nq, T]   running max of the live scores,
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
// skipped, because merge_stats has no guards against -inf or NaN.
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
// Design (simple first, as for the flash kernels; the tile machinery is
// flash_tiles.cuh, shared with them):
// * one thread block per (64 query rows, query head, batch row); a loop
//   over 64-key tiles inside the block replaces the Pallas grid's
//   sequential reduction axis, (m, l, acc) stay in registers and are
//   written out raw at the end;
// * bf16 on the tensor cores (4 warps, mma.sync m16n8k16): P enters P.V
//   rounded to bf16 (at most 2^-8 of sum_j p_j |v_j| / l per output),
//   while l sums the f32 probabilities, as the flash kernels do;
//   f32 on the CUDA cores in f32 throughout (held to 1e-4);
// * float K/V [B, S, Kv, H] or int8 codes [B, Kv, S, H] are both read
//   through (batch, key, head) element strides; int8 codes widen to bf16
//   exactly and feed the tensor cores, their scales fold as on the TPU;
// * a position-based tile skip: a key tile whose smallest position
//   exceeds the largest query position of the block is skipped whole
//   (one __syncthreads_or over the staged positions). It gives the causal
//   saving on the diagonal ring block and skips a later block entirely,
//   which the TPU's index-based skip cannot.
// Head dims 64 and 128 (GPT-2, Llama); any other raises in the wrapper.
// Not yet done (a later change): a split over S for T = 1 (flash-
// decoding), wgmma on 64-row warpgroup tiles, TMA pipelining of K/V.

#include "flash_tiles.cuh"

#include <climits>
#include <type_traits>

namespace {

using namespace bt;

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
  long long ksb, kss, ksh;
  int T, S, Nq, Kv;
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

// f32 on the CUDA cores.
template <typename KT, int H, bool QUANT>
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
  const float* qb = static_cast<const float*>(a.q) +
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

template <typename KT, int H, bool QUANT>
int launch(const RingArgs& a, int B, cudaStream_t stream) {
  constexpr int LD = H + 4;
  const size_t bytes =
      (static_cast<size_t>(BQ + BK) * LD + BQ * LDP + 2 * BK) * sizeof(float);
  auto kern = ring_kernel<KT, H, QUANT>;
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  const dim3 grid((a.T + BQ - 1) / BQ, a.Nq, B);
  kern<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores.
template <typename T, typename KT, int H, bool QUANT>
__global__ void __launch_bounds__(NT_MMA) ring_mma_kernel(RingArgs a) {
  constexpr int LDH = H + 8;
  extern __shared__ uint4 smem16[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem16);  // [BQ][LDH]
  uint16_t* ks = qs + BQ * LDH;                         // [BK][LDH]
  uint16_t* vs = ks + BK * LDH;                         // [BK][LDH]
  float* ksc = reinterpret_cast<float*>(vs + BK * LDH); // [BK] (int8)
  float* vsc = ksc + BK;
  __shared__ int qps[BQ], kps[BK], qmax_s;
  const int q0 = blockIdx.x * BQ, n = blockIdx.y, b = blockIdx.z;
  const int kv = n / (a.Nq / a.Kv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long qstride = static_cast<long long>(a.Nq) * H;
  const T* qb = static_cast<const T*>(a.q) +
                (static_cast<long long>(b) * a.T * a.Nq + n) * H;
  load_rows_t<T, H, BQ>(qs, qb, qstride, q0, a.T);
  const int qmax = stage_qpos(a, b, q0, qps, &qmax_s);  // syncs: Q staged
  uint32_t qa[H / 16][4];
  load_q_frags<H>(qs, qa);

  MmaState<H> st;
  init_state(st);
  const float scale = 1.0f / sqrtf(static_cast<float>(H));
  const Block<KT> blk = block_of<KT, QUANT>(a, b, kv);
  for (int c0 = 0; c0 < a.S; c0 += BK) {
    if (!stage_kpos(a, b, c0, qmax, kps)) continue;  // block-uniform
    fold_tile_mma<T, H, KT, QUANT, true>(qa, ks, vs, ksc, vsc, blk.kb,
                                         blk.vb, a.kss, c0, a.S, blk.ksg,
                                         blk.vsg, false, warp * 16, qps, kps,
                                         scale, st);
  }

  const long long rbase = (static_cast<long long>(b) * a.Nq + n) * a.T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row < a.T) {
      if (t == 0) {
        a.m[rbase + row] = fmaxf(st.m[h], NEG);
        a.l[rbase + row] = st.l[h];
      }
      float* ar = a.acc + (rbase + row) * H;
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
        *reinterpret_cast<float2*>(ar + j * 8 + t * 2) =
            make_float2(st.o[j][2 * h], st.o[j][2 * h + 1]);
    }
  }
}

template <typename T, typename KT, int H, bool QUANT>
int launch_mma(const RingArgs& a, int B, cudaStream_t stream) {
  constexpr int LDH = H + 8;
  const size_t bytes = static_cast<size_t>(BQ + 2 * BK) * LDH *
                           sizeof(uint16_t) + 2 * BK * sizeof(float);
  auto kern = ring_mma_kernel<T, KT, H, QUANT>;
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  const dim3 grid((a.T + BQ - 1) / BQ, a.Nq, B);
  kern<<<grid, NT_MMA, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int launch_h(int dtype, bool quant, const RingArgs& a, int B,
             cudaStream_t s) {
  if (dtype == 0)
    return quant ? launch<int8_t, H, true>(a, B, s)
                 : launch<float, H, false>(a, B, s);
  if (dtype == 2)
    return quant ? launch_mma<__nv_bfloat16, int8_t, H, true>(a, B, s)
                 : launch_mma<__nv_bfloat16, __nv_bfloat16, H, false>(a, B,
                                                                      s);
  return -1;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 2 = bfloat16 (tensor cores), for q and
// float k/v; quant != 0: k/v are int8 codes with f32 scales ks/vs
// [B, Kv, S] (contiguous). q [B, T, Nq, H], qpos [B, T], kpos [B, S], m/l
// [B, Nq, T] and acc [B, Nq, T, H] contiguous; k/v rows (b, c, kv) at
// element offsets b*ksb + c*kss + kv*ksh with a contiguous last dim.
// Returns 0 on success, -1 for an unsupported dtype or head_dim, else the
// cudaError_t of the launch.
extern "C" int bt_ring_stats(int dtype, int quant, const void* q,
                             const void* k, const void* v, const float* ks,
                             const float* vs, const int* qpos,
                             const int* kpos, float* m, float* l, float* acc,
                             int B, int T, int S, int Nq, int Kv, int H,
                             long long ksb, long long kss, long long ksh,
                             void* stream) {
  const RingArgs a{q, k, v, ks, vs, qpos, kpos, m, l, acc,
                   ksb, kss, ksh, T, S, Nq, Kv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return launch_h<64>(dtype, quant != 0, a, B, s);
    case 128: return launch_h<128>(dtype, quant != 0, a, B, s);
    default: return -1;
  }
}
