// The fresh flash prefill kernel on Hopper's warpgroup MMA (wgmma), for
// bf16 / f16 at head dims 64 and 128 (GPT-2, Llama-3-8B): see
// flash_fresh_wg_kernel. Only flash_attention.cu includes this header; the
// warm and ring kernels keep flash_tiles.cuh's mma.sync tiles.
//
// * A block owns BQ = 128 query rows of one query head: two warpgroups of
//   64 rows, each issuing its own wgmma. The 256 threads fill a ring of 2
//   shared-memory stages of 64-key K and V tiles with cp.async (16 bytes
//   a thread, rows past T zero-filled), so tile j + 1 streams in while
//   tile j is multiplied.
// * Tiles sit in shared memory in the 128-byte swizzle the wgmma
//   descriptors name (a row's 16-byte chunk c lands at chunk c ^ (row % 8),
//   in column blocks of 64 elements, 1024-byte aligned), written by hand
//   on the way in.
// * S = Q.K^T: wgmma m64n64k16 with Q and K from shared memory (both
//   K-major). P.V: wgmma m64nHk16 with P from registers (the score
//   accumulators rounded to q's dtype are exactly the A fragments) and V
//   from shared memory in its row-major [key][h] layout, read through the
//   instruction's transpose bit (MN-major B), so no copy is transposed.
// * Online softmax in base 2: the max is taken on the raw scores, then
//   each probability is one FFMA (log2(e) / sqrt(H) folded in) and one
//   ex2.approx; maxima and sums reduce in four independent chains; the
//   denominator is summed per lane and reduced across the quad once at
//   the end. Masking only on tiles that cross the diagonal or the ragged
//   end T; a warpgroup skips a tile that is wholly above its diagonal. (On an H100 this elementwise
//   work, not the MMAs or the copies, sets the kernel's time: without it
//   the kernel ran 2.9x faster; 128-key tiles or a third stage moved it
//   by less than 4%.)
// * Launch order: blockIdx.x runs over query heads fastest, so the G heads
//   of one kv head are adjacent blocks and read the same K/V tiles, from
//   HBM once and from L2 after; causal grids launch the heaviest (last)
//   query tiles first. ops/flash_attention.py:fresh_block_order is the
//   same order in Python.
#pragma once

#include "flash_tiles.cuh"

namespace bt {
namespace wg {

constexpr int BQ = 128;        // query rows per block
constexpr int BKW = 64;        // keys per tile
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int STAGES = 2;      // K/V tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

struct FreshArgs {
  const void* q;  // [B, T, Nq, H]
  const void* k;  // [B, T, Kv, H]
  const void* v;
  void* out;      // [B, T, Nq, H]
  int T, Nq, Kv, causal, ntiles;
};

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulators across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special-function unit (relative error ~2^-22, well inside
// the bf16 rounding of P; 2^-huge is exactly +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Max (MAX) or sum of row h's (a for h = 0, b for 1) score accumulators
// s[4jj + 2h], s[4jj + 2h + 1] of this lane, in four independent chains.
template <int BKW_, bool MAX>
__device__ __forceinline__ float row_reduce(const float (&s)[BKW_ / 2],
                                            int h) {
  auto op = [](float x, float y) { return MAX ? fmaxf(x, y) : x + y; };
  float v0 = s[2 * h], v1 = s[2 * h + 1];
  float v2 = s[4 + 2 * h], v3 = s[5 + 2 * h];
#pragma unroll
  for (int jj = 2; jj < BKW_ / 8; jj += 2) {
    v0 = op(v0, s[4 * jj + 2 * h]);
    v1 = op(v1, s[4 * jj + 2 * h + 1]);
    v2 = op(v2, s[4 * jj + 4 + 2 * h]);
    v3 = op(v3, s[4 * jj + 5 + 2 * h]);
  }
  return op(op(v0, v1), op(v2, v3));
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// Byte offset of 16-byte chunk ch (elements 8ch .. 8ch + 7) of row r in a
// tile of ROWS rows, stored as column blocks of 64 elements x ROWS rows of
// 128 bytes, 128-byte swizzled.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (ch >> 3) * (ROWS * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// D (64 x N, f32) = A (64 x 16, shared) . B (16 x N, shared, K-major),
// accumulated into D when scale_d != 0.
template <typename T, int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
// D (64 x N, f32) += A (64 x 16, registers) . B (16 x N, shared,
// MN-major: the transpose bit set).
template <typename T, int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 64>(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<__half, 64>(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<__half, 64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<__half, 128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Two blocks per SM: at H = 128 that caps a thread at 128 registers (32
// bytes spill), which ran 11% faster on an H100 than one block of 143.
template <typename T, int H>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fresh_wg_kernel(FreshArgs a) {
  constexpr int Q_BYTES = BQ * H * 2;
  constexpr int KV_BYTES = BKW * H * 2;
  constexpr int C16 = H / 8;  // 16-byte chunks per row
  constexpr int NS = BKW / 2;  // score accumulators per thread
  extern __shared__ __align__(128) uint8_t wg_smem[];
  const uint32_t pad = (1024u - (smem_u32(wg_smem) & 1023u)) & 1023u;
  uint8_t* qs = wg_smem + pad;               // [H/64][BQ][128 B]
  uint8_t* ks = qs + Q_BYTES;                // [STAGES][H/64][BKW][128 B]
  uint8_t* vs = ks + STAGES * KV_BYTES;

  // heads fastest (a kv group's G heads adjacent); causal: last tile first
  int bid = blockIdx.x;
  const int n = bid % a.Nq;
  bid /= a.Nq;
  const int ti = bid % a.ntiles, b = bid / a.ntiles;
  const int q0 = (a.causal ? a.ntiles - 1 - ti : ti) * BQ;
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

  for (int e = tid; e < BQ * C16; e += NTHREADS) {
    const int r = e / C16, ch = e - r * C16;
    const bool ok = q0 + r < a.T;
    cp_async16(qs + swz<BQ>(r, ch),
               qb + (ok ? q0 + r : 0) * qstride + ch * 8, ok);
  }
  const int kend = a.causal ? min(a.T, q0 + BQ) : a.T;
  const int nk = (kend + BKW - 1) / BKW;
  auto load_kv = [&](int j) {
    uint8_t* kd = ks + (j % STAGES) * KV_BYTES;
    uint8_t* vd = vs + (j % STAGES) * KV_BYTES;
    const int c0 = j * BKW;
    for (int e = tid; e < BKW * C16; e += NTHREADS) {
      const int r = e / C16, ch = e - r * C16;
      const bool ok = c0 + r < a.T;
      const long long off = (ok ? c0 + r : 0) * kstride + ch * 8;
      cp_async16(kd + swz<BKW>(r, ch), kb + off, ok);
      cp_async16(vd + swz<BKW>(r, ch), vb + off, ok);
    }
  };
  // tiles 0 .. STAGES - 2 in flight (Q rides in the first group)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load_kv(i);
    cp_async_commit();
  }

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
    const int c0 = j * BKW;
    if (!a.causal || c0 <= r0 + 63) {  // some pair of this warpgroup lives
      const uint32_t kaddr = smem_u32(ks + (j % STAGES) * KV_BYTES);
      const uint32_t vaddr = smem_u32(vs + (j % STAGES) * KV_BYTES);
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

      // s[4jj + e]: row a (e < 2) or b, column c0 + 8jj + 2t + (e & 1).
      // Only a tile crossing the diagonal or the ragged end T is masked.
      const bool masked = (a.causal && c0 + BKW - 1 > r0) || c0 + BKW > a.T;
      if (masked) {
#pragma unroll
        for (int jj = 0; jj < BKW / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + jj * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (!(col < a.T && (!a.causal || col <= row))) s[4 * jj + e] = NEG;
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
      // p = 2^(s * log2(e) / sqrt(H) - m'): one FFMA and one ex2 each. A
      // masked score (-1e30) gives exactly 0 once the row has a live key;
      // key 0 is live for every row of the first tile, so it always has.
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = fast_exp2(fmaf(s[i], scale2, -ms[(i >> 1) & 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = l[h] * corr[h] + row_reduce<BKW, false>(s, h);
#pragma unroll
      for (int i = 0; i < H / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // the probabilities of keys 16kk .. 16kk + 15, rounded to T, are the
      // A fragment of the kk-th k-step (l summed the f32 values)
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
      for (int kk = 0; kk < BKW / 16; ++kk)  // 16 keys: 2 groups of 8 rows
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

template <typename T, int H>
int launch_fresh_wg(const FreshArgs& a, int B, cudaStream_t stream) {
  const size_t bytes = BQ * H * 2 + 2 * STAGES * BKW * H * 2 + 1024;
  auto kern = flash_fresh_wg_kernel<T, H>;
  const int e = allow_smem(kern, bytes);
  if (e != 0) return e;
  kern<<<a.ntiles * a.Nq * B, NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace bt
