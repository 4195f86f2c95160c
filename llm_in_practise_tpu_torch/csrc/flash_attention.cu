// Causal flash attention for Hopper (sm_90a): forward, dK/dV and dQ.
//
// Replaces the TPU kernels of llm_in_practise_tpu/ops/flash_attention.py:
//   - flash_fwd_kernel     <- _fwd_kernel      (pallas_call in _flash_fwd_call)
//   - flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (first pallas_call in
//                                               _flash_bwd_call)
//   - flash_bwd_dq_kernel  <- _bwd_dq_kernel   (second pallas_call there)
// They compute the same functions: O = softmax(scale * Q K^T + causal) V with
// the per-row log-sum-exp LSE (natural log, f32), and the FlashAttention-2
// backward from the saved LSE with delta = rowsum(dO * O) computed by the
// caller: P = exp(scale * Q K^T - LSE), dV = P^T dO, dP = dO V^T,
// dS = P * (dP - delta), dQ = scale * dS K, dK = scale * dS^T Q.
//
// Layout: q, k, v, dO are (B, L, heads, D) read through the strides the
// caller passes (elements; D is contiguous), so no moveaxis copy is made.
// GQA is native: query head h reads KV head h / (H / Hkv); K and V are never
// repeated in memory. Outputs O, dQ, dK, dV are written contiguous
// (B, L, heads, D) in bf16; LSE is (B, H, L) f32. The ragged edge (L not a
// multiple of the tile) is masked, not padded.
//
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the training
// shapes (B 8, L 1024, H 32, Hkv 8, D 128) all three are bound by tensor-core
// operations on the live (causal) half of the score matrix: 2 products in the
// forward (QK^T, PV), 4 in dK/dV (QK^T, P^T dO, dO V^T, dS^T Q) and 3 in dQ
// (QK^T, dO V^T, dS K).
//
// What the design does about that bound. All three kernels share one shape:
// wgmma + TMA, one producer warp and two consumer warpgroups (setmaxnreg
// gives the consumers the registers), tiles in 64-column panels of 128-byte
// rows with the 128-byte swizzle (as TMA writes them through 4-D tensor maps
// over the caller's strided (B, L, heads, D) layout and the wgmma
// descriptors read them), full/empty mbarrier pairs around a ring of
// streamed tiles, f32 accumulators in registers, and an epilogue that
// rounds once to bf16, stages the rows in the warpgroup's own (now unread)
// tile rows and writes 16-byte stores of the rows below L.
//   - Causally dead tiles are never visited: a query tile loops over key
//     tiles up to the diagonal, a key tile over query tiles from it on; only
//     the diagonal tile and the ragged one pay for the mask. The longest
//     tiles go first, to shorten the tail of the grid. Softmax statistics
//     stay in f32 (exp2 with the scale folded in).
//   - The accumulator of a product is, rounded to bf16 in place, the A
//     fragment (registers) of the next one: P for P V, and dS for dS K in
//     dQ; dK/dV computes S^T and dP^T (keys as rows) for the same reason,
//     so P^T and dS^T feed P^T dO and dS^T Q with no shuffle. The second
//     operand of those products is read MN-major through wgmma's transpose
//     bit.
//   - Forward (flash_fwd_kernel): one block per (128-row query tile, query
//     head, batch), the G query heads of one KV head on adjacent blocks so
//     their K/V tiles are L2 hits. The producer loads the Q tile once and
//     keeps a 2-stage ring of 128-key K and V tiles; each warpgroup owns 64
//     query rows: S = Q K^T (m64n128k16, both operands in shared memory),
//     the online softmax on the f32 fragments, O += P V. The two warpgroups
//     run unsynchronised, so one's softmax overlaps the other's products.
//   - dQ (flash_bwd_dq_kernel): the forward's blocks and ring, with dO
//     loaded beside Q: S = Q K^T and dP = dO V^T (m64n128k16, two groups:
//     P is computed while dP runs), dS = P * (dP - delta) on the fragments
//     (each thread holds the LSE and delta of its two rows in registers),
//     dQ += dS K.
//   - dK/dV (flash_bwd_dkv_kernel): one block per (128-key tile, KV head,
//     batch), early key tiles (the longest) first; K and V are loaded once,
//     each warpgroup owns 64 keys and keeps dK and dV in registers. The
//     producer streams 64-row (Q, dO) tiles for each query head of the
//     group and each live query tile through a 3-stage ring; its warp also
//     writes the tile's 64 LSE (times log2 e) and 64 delta values into the
//     stage, by plain loads (a TMA row start is not 16-byte aligned for
//     every L). Per stage: S^T = K Q^T and dP^T = V dO^T (m64n64k16),
//     P^T = exp2(S^T * scale log2 e - LSE log2 e) (zero for every query at or
//     past L: its LSE is no row's), dV += P^T dO, dS^T = P^T * (dP^T -
//     delta), dK += dS^T Q. A warpgroup whose 64 keys all lie past the
//     tile's queries skips it.
//   - Deterministic: every output row is summed in one block in a fixed
//     order (dK/dV: query heads, then query tiles); no atomics.
// The mma.sync designs that these replaced took 0.379 ms (forward), 0.6525
// ms (dK/dV) and 0.5543 ms (dQ) at the training shapes: 2.45x SDPA's forward
// and, as a pair, 1.85x SDPA's backward (NVIDIA H100 80GB HBM3, 700 W).

#include <math.h>

#include "qmm_wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

namespace flash {

constexpr int kBM = 128;            // query rows per forward / dQ block
constexpr int kBN = 128;            // keys per K/V tile
constexpr int kBQ = 64;             // query rows per dK/dV stage
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kStages = 2;          // K/V ring depth (forward, dQ)
constexpr int kQStages = 3;         // (Q, dO) ring depth (dK/dV)
constexpr int kPanel = 128 * 128;   // bytes of one 64-column panel, 128 rows
constexpr int kPanelQ = kBQ * 128;  // the same for a 64-row tile

template <int D>
__host__ __device__ constexpr int tile_bytes() { return (D / 64) * kPanel; }
template <int D>
__host__ __device__ constexpr int qtile_bytes() { return (D / 64) * kPanelQ; }
// dynamic shared memory, 1024 bytes for the alignment of the swizzle
template <int D>
__host__ __device__ constexpr int fwd_smem() {  // Q, the K/V ring
  return (1 + 2 * kStages) * tile_bytes<D>() + 1024;
}
template <int D>
__host__ __device__ constexpr int dq_smem() {  // Q, dO, the K/V ring
  return (2 + 2 * kStages) * tile_bytes<D>() + 1024;
}
template <int D>
__host__ __device__ constexpr int dkv_smem() {  // K, V, the (Q, dO) ring
  return 2 * tile_bytes<D>() + 2 * kQStages * qtile_bytes<D>() + 1024;
}

// d (64 x 128, f32) += a (64 x 16, bf16, shared memory at desc_a) . b
// (16 x 128, bf16, shared memory at desc_b), both K-major
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, bf16, shared memory at desc_a) . b
// (16 x 64, bf16, shared memory at desc_b), both K-major
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, bf16, registers) . b (16 x 128, bf16,
// shared memory at desc_b, MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += a (64 x 16, bf16, registers) . b (16 x 64, bf16,
// shared memory at desc_b, MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// an MN-major operand in 128-byte-swizzled 64-column panels: 8-row groups
// 1024 bytes apart along the reduction (SBO), panels `lbo` bytes apart
// along the output columns (LBO)
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}

// box at (d, head, row, batch) of a 4-D tensor map into shared memory
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          qmm::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(qmm::smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// every 64-column panel of a tile of `rows` rows of one head: rows r0 ..
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int panel_bytes,
                                         int head, int r0, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load_4d(dst + p * panel_bytes, map, bar, 64 * p, head, r0, b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc (64 x D) += a (64 x 16, registers) . b (16 x D, MN-major at desc_b)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  wgmma_m64n128k16_rs_tb(acc, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  wgmma_m64n64k16_rs_tb(acc, a, desc_b);
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) qmm::fence_operand(r[i]);
}

// A fragments stay live (their registers unreused) up to here: a wgmma
// reads them until its group is waited for
template <int N>
__device__ __forceinline__ void fence_all(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) qmm::fence_operand(a[i][r]);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

__device__ __forceinline__ void wgmma_begin() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are pending (groups
// complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_end() {
  wgmma_commit();
  wgmma_wait<0>();
}

// d (64 x N) = a . b^T over D, a the 64 rows at a_base of a tile whose
// panels are a_panel bytes apart, b the N rows at b_base (panels b_panel
// apart), both K-major in shared memory: S = Q K^T, dP = dO V^T (N = 128)
// and S^T = K Q^T, dP^T = V dO^T (N = 64)
template <int D, int N>
__device__ __forceinline__ void wgmma_abt(float (&d)[N / 2], uint32_t a_base,
                                          int a_panel, uint32_t b_base,
                                          int b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // +32 bytes per k16 step inside a panel
    const uint64_t da = qmm::desc_sw128(a_base + (kk / 4) * a_panel +
                                        (kk % 4) * 32);
    const uint64_t db = qmm::desc_sw128(b_base + (kk / 4) * b_panel +
                                        (kk % 4) * 32);
    if constexpr (N == 128) {
      wgmma_m64n128k16_ss(d, da, db);
    } else {
      wgmma_m64n64k16_ss(d, da, db);
    }
  }
}

// the 64 x N f32 accumulator (N = 8 x 2 per k16 step), rounded to bf16 in
// place, as A fragments over its columns: columns 16kk .. 16kk + 15 are
// accumulator column pairs j = 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = qmm::pack2(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = qmm::pack2(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = qmm::pack2(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = qmm::pack2(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// rows r_lo (times mul0) and r_lo + 8 (times mul1) of a 64 x D accumulator,
// rounded once to bf16, into a 128-row tile in the swizzled panel layout
// (fragment layout of qmm_wgmma.cuh: acc[4j + e] is row r_lo + 8 (e / 2),
// column 8j + 2t + e % 2)
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* tile,
                                           const float (&acc)[D / 2],
                                           int r_lo, int t, float mul0,
                                           float mul1) {
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r_lo + 8 * hr;
      const float mul = hr ? mul1 : mul0;
      uint8_t* dst =
          tile + (jj / 8) * kPanel + r * 128 + ((((jj % 8) ^ r) & 7) << 4) +
          4 * t;
      *reinterpret_cast<uint32_t*>(dst) = qmm::pack2(
          acc[4 * jj + 2 * hr] * mul, acc[4 * jj + 2 * hr + 1] * mul);
    }
  }
}

// warpgroup wg's 64 staged rows of a 128-row tile as 16-byte stores to rows
// row0 + 64 wg .. of a (.., D) slice with row stride ld; rows at or past L
// are skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long ld,
                                           const uint8_t* tile, int wg,
                                           int row0, int L, int tid) {
  for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
    const int r = 64 * wg + i / (D / 8);
    const int c = i % (D / 8);  // 16-byte chunk of the row
    const int row = row0 + r;
    if (row >= L) continue;
    const uint8_t* src =
        tile + (c / 8) * kPanel + r * 128 + ((((c % 8) ^ r) & 7) << 4);
    *reinterpret_cast<uint4*>(out + row * ld + c * 8) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// the named barrier of warpgroup wg (0 is __syncthreads, 1 the mainloop's)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// the work of a forward or dQ block: the longest (latest) query tiles
// first, the G query heads of one KV head on adjacent blocks (their K/V
// tiles are L2 hits)
struct QBlock {
  int h, hk, b;  // query head, its KV head, batch
  int q0;        // first query row
  int n_kt;      // key tiles up to the diagonal (kBN == kBM)
  __device__ QBlock(int B, int L, int H, int Hkv) {
    const int G = H / Hkv;
    const int n_qt = (L + kBM - 1) / kBM;
    int idx = blockIdx.x;
    const int hg = idx % G;
    idx /= G;
    hk = idx % Hkv;
    idx /= Hkv;
    b = idx % B;
    const int qt = n_qt - 1 - idx / B;
    h = hk * G + hg;
    q0 = qt * kBM;
    n_kt = qt + 1;
  }
};

// the 1024-byte-aligned start of dynamic shared memory: the 128-byte
// swizzle repeats every 1024 bytes, so tiles start there
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (qmm::smem_u32(raw) & 1023)) & 1023);
}

}  // namespace flash

// ---------------------------------------------------------------- forward
// flash_fwd_kernel: one block per (128-row query tile, query head, batch).
// Shared memory holds the Q tile and a ring of kStages K and V tiles.
template <int D>
__global__ void __launch_bounds__(flash::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int B, int L, int H, int Hkv, float scale_log2) {
  using namespace flash;
  constexpr int T = tile_bytes<D>();   // bytes of one 128-row tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  uint8_t* sQ = aligned_smem(smem_raw);
  uint8_t* sK = sQ + T;             // kStages tiles
  uint8_t* sV = sK + kStages * T;   // kStages tiles

  const QBlock blk(B, L, H, Hkv);
  const int h = blk.h, hk = blk.hk, b = blk.b, q0 = blk.q0, n_kt = blk.n_kt;

  if (threadIdx.x == 0) {
    qmm::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      qmm::mbar_init(&k_full[s], 1);
      qmm::mbar_init(&v_full[s], 1);
      qmm::mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      qmm::mbar_expect_tx(&q_full, T);
      tma_tile<D>(sQ, &tm_q, &q_full, kPanel, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) qmm::mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        qmm::mbar_expect_tx(&k_full[s], T);
        tma_tile<D>(sK + s * T, &tm_k, &k_full[s], kPanel, hk, j * kBN, b);
        qmm::mbar_expect_tx(&v_full[s], T);
        tma_tile<D>(sV + s * T, &tm_v, &v_full[s], kPanel, hk, j * kBN, b);
      }
    }
  } else {  // consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // this thread's rows in the tile: r_lo and r_lo + 8 (fragment layout
    // of qmm_wgmma.cuh: d[4j + e] is row 16 warp + g + 8 (e / 2), column
    // 8j + 2t + e % 2)
    const int r_lo = 64 * wg + 16 * warp + g;

    float acc[D / 2];
    zero(acc);
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};
    const uint32_t q_base = qmm::smem_u32(sQ) + wg * 64 * 128;

    qmm::mbar_wait(&q_full, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const uint32_t k_base = qmm::smem_u32(sK + s * T);
      const uint32_t v_base = qmm::smem_u32(sV + s * T);

      // S = Q K^T: 64 rows x 128 keys, f32
      float sc[64];
      zero(sc);
      qmm::mbar_wait(&k_full[s], ph);
      fence_all(sc);
      wgmma_begin();
      wgmma_abt<D, kBN>(sc, q_base, kPanel, k_base, kPanel);
      wgmma_end();
      fence_all(sc);

      // the diagonal tile is the last one and the only one with a mask;
      // keys past L (TMA's zero fill, score 0) lie past every valid row, so
      // the causal mask covers them
      if (j == n_kt - 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = 8 * (i / 4) + 2 * t + (i & 1);
          const int row = r_lo + 8 * ((i / 2) & 1);
          if (key > row) sc[i] = -INFINITY;
        }
      }
      // online softmax, rows r_lo (hr 0) and r_lo + 8 (hr 1), in log2 units
      // with the scale folded in
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * hr], sc[4 * jj + 2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // key 0 is live for every row, so m is finite from the first tile on
        const float m_new = fmaxf(m_run[hr], mx * scale_log2);
        const float alpha = ex2(m_run[hr] - m_new);
        m_run[hr] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * hr + e;
            sc[i] = ex2(fmaf(sc[i], scale_log2, -m_new));
            sum += sc[i];
          }
        }
        l_run[hr] = l_run[hr] * alpha + sum;  // this thread's partial sum
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          acc[4 * jj + 2 * hr] *= alpha;
          acc[4 * jj + 2 * hr + 1] *= alpha;
        }
      }
      uint32_t pa[8][4];
      to_a<kBN>(pa, sc);

      // O += P V: V read MN-major through the transpose bit, 16 keys
      // (2048 bytes) per step, panels kPanel bytes apart
      qmm::mbar_wait(&v_full[s], ph);
      fence_all(acc);
      wgmma_begin();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<D>(acc, pa[kk], desc_sw128_mn(v_base + kk * 2048, kPanel));
      wgmma_end();
      fence_all(acc);
      fence_all(pa);
      qmm::mbar_arrive(&empty[s]);
    }

    // epilogue: O / l rounded once to bf16, staged in this warpgroup's own
    // (now unread) Q rows, then stored; LSE = m + log(l), natural log
    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_run[hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[hr] = 1.0f / l;
      const int row = q0 + r_lo + 8 * hr;
      if (t == 0 && row < L) {
        lse[(static_cast<long>(b) * H + h) * L + row] =
            (m_run[hr] + log2f(l)) * kLn2;
      }
    }
    stage_rows<D>(sQ, acc, r_lo, t, inv[0], inv[1]);
    warpgroup_sync(wg);
    const long o_sl = static_cast<long>(H) * D;
    store_rows<D>(o + static_cast<long>(b) * L * o_sl + h * D, o_sl, sQ, wg,
                  q0, L, tid);
  }
}

// ------------------------------------------------------------------ dQ
// flash_bwd_dq_kernel: the forward's blocks (128-row query tile, query
// head, batch) and K/V ring, with the dO tile loaded beside Q.
template <int D>
__global__ void __launch_bounds__(flash::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int B, int L, int H,
                    int Hkv, float scale, float scale_log2) {
  using namespace flash;
  constexpr int T = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  uint8_t* sQ = aligned_smem(smem_raw);
  uint8_t* sdO = sQ + T;
  uint8_t* sK = sdO + T;            // kStages tiles
  uint8_t* sV = sK + kStages * T;   // kStages tiles

  const QBlock blk(B, L, H, Hkv);
  const int h = blk.h, hk = blk.hk, b = blk.b, q0 = blk.q0, n_kt = blk.n_kt;

  if (threadIdx.x == 0) {
    qmm::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      qmm::mbar_init(&k_full[s], 1);
      qmm::mbar_init(&v_full[s], 1);
      qmm::mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      qmm::mbar_expect_tx(&q_full, 2 * T);
      tma_tile<D>(sQ, &tm_q, &q_full, kPanel, h, q0, b);
      tma_tile<D>(sdO, &tm_do, &q_full, kPanel, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) qmm::mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        qmm::mbar_expect_tx(&k_full[s], T);
        tma_tile<D>(sK + s * T, &tm_k, &k_full[s], kPanel, hk, j * kBN, b);
        qmm::mbar_expect_tx(&v_full[s], T);
        tma_tile<D>(sV + s * T, &tm_v, &v_full[s], kPanel, hk, j * kBN, b);
      }
    }
  } else {  // consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r_lo = 64 * wg + 16 * warp + g;  // rows r_lo and r_lo + 8

    // LSE (log2 units) and delta of this thread's two rows; rows past L
    // (zero Q and dO from TMA's fill) take 0 and give dS = 0
    float lse2[2], dlt[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + r_lo + 8 * hr;
      const long i = (static_cast<long>(b) * H + h) * L + row;
      lse2[hr] = row < L ? lse[i] * kLog2e : 0.0f;
      dlt[hr] = row < L ? delta[i] : 0.0f;
    }

    float acc[D / 2];  // dQ / scale
    zero(acc);
    const uint32_t q_base = qmm::smem_u32(sQ) + wg * 64 * 128;
    const uint32_t do_base = qmm::smem_u32(sdO) + wg * 64 * 128;

    qmm::mbar_wait(&q_full, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const uint32_t k_base = qmm::smem_u32(sK + s * T);
      const uint32_t v_base = qmm::smem_u32(sV + s * T);

      // S = Q K^T and dP = dO V^T: 64 rows x 128 keys each, f32, in two
      // groups: P is computed while dP runs
      float sc[64], dp[64];
      zero(sc);
      zero(dp);
      fence_all(sc);
      fence_all(dp);
      qmm::mbar_wait(&k_full[s], ph);
      wgmma_begin();
      wgmma_abt<D, kBN>(sc, q_base, kPanel, k_base, kPanel);
      wgmma_commit();
      qmm::mbar_wait(&v_full[s], ph);
      wgmma_abt<D, kBN>(dp, do_base, kPanel, v_base, kPanel);
      wgmma_commit();
      wgmma_wait<1>();
      fence_all(sc);

      // P = exp2(S scale log2 e - LSE log2 e); only the diagonal (last)
      // tile is masked: keys past L lie past every valid row
      const bool diag = j == n_kt - 1;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int hr = (i / 2) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[hr]));
        if (diag && 8 * (i / 4) + 2 * t + (i & 1) > r_lo + 8 * hr) p = 0.0f;
        sc[i] = p;
      }
      // dS / scale = P * (dP - delta)
      wgmma_wait<0>();
      fence_all(dp);
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= dp[i] - dlt[(i / 2) & 1];
      uint32_t da[8][4];
      to_a<kBN>(da, sc);

      // dQ += dS K: K read MN-major through the transpose bit
      fence_all(acc);
      wgmma_begin();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<D>(acc, da[kk], desc_sw128_mn(k_base + kk * 2048, kPanel));
      wgmma_end();
      fence_all(acc);
      fence_all(da);
      qmm::mbar_arrive(&empty[s]);
    }

    stage_rows<D>(sQ, acc, r_lo, t, scale, scale);
    warpgroup_sync(wg);
    const long o_sl = static_cast<long>(H) * D;
    store_rows<D>(dq + static_cast<long>(b) * L * o_sl + h * D, o_sl, sQ, wg,
                  q0, L, tid);
  }
}

// --------------------------------------------------------------- dK / dV
// flash_bwd_dkv_kernel: one block per (128-key tile, KV head, batch). Shared
// memory holds the K and V tiles and a ring of kQStages (Q, dO) 64-row
// tiles; each stage's LSE and delta rows sit beside it in static memory.
template <int D>
__global__ void __launch_bounds__(flash::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int B, int L, int H,
                     int Hkv, float scale, float scale_log2) {
  using namespace flash;
  constexpr int T = tile_bytes<D>();
  constexpr int TQ = qtile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[kQStages];
  __shared__ __align__(8) uint64_t empty[kQStages];
  __shared__ __align__(16) float sL[kQStages][kBQ];  // LSE log2 e
  __shared__ __align__(16) float sD[kQStages][kBQ];  // delta
  uint8_t* sK = aligned_smem(smem_raw);
  uint8_t* sV = sK + T;
  uint8_t* sQ = sV + T;                // kQStages tiles
  uint8_t* sdO = sQ + kQStages * TQ;   // kQStages tiles

  // block -> (KV head, batch, key tile): the early key tiles (the most
  // live query tiles) first
  const int G = H / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int b = (blockIdx.x / Hkv) % B;
  const int kt = blockIdx.x / (Hkv * B);
  const int k0 = kt * kBN;
  const int n_q = (L + kBQ - 1) / kBQ - k0 / kBQ;  // live query tiles a head
  const int n_it = G * n_q;  // query heads, then query tiles: a fixed order

  if (threadIdx.x == 0) {
    qmm::mbar_init(&kv_full, 1);
    for (int s = 0; s < kQStages; ++s) {
      qmm::mbar_init(&full[s], 32);  // the producer warp's lanes
      qmm::mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one warp; lane 0 issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < kConsumers + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        qmm::mbar_expect_tx(&kv_full, 2 * T);
        tma_tile<D>(sK, &tm_k, &kv_full, kPanel, hk, k0, b);
        tma_tile<D>(sV, &tm_v, &kv_full, kPanel, hk, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kQStages;
        if (it >= kQStages)
          qmm::mbar_wait(&empty[s], ((it / kQStages) - 1) & 1);
        const int h = hk * G + it / n_q;
        const int q0 = k0 + (it % n_q) * kBQ;
        // the tile's LSE and delta by plain loads, two rows a lane; rows
        // past L take 0 (their P is masked)
        const long base = (static_cast<long>(b) * H + h) * L;
#pragma unroll
        for (int r = lane; r < kBQ; r += 32) {
          const bool live = q0 + r < L;
          sL[s][r] = live ? lse[base + q0 + r] * kLog2e : 0.0f;
          sD[s][r] = live ? delta[base + q0 + r] : 0.0f;
        }
        if (lane == 0) {
          qmm::mbar_expect_tx(&full[s], 2 * TQ);
          tma_tile<D>(sQ + s * TQ, &tm_q, &full[s], kPanelQ, h, q0, b);
          tma_tile<D>(sdO + s * TQ, &tm_do, &full[s], kPanelQ, h, q0, b);
        } else {
          qmm::mbar_arrive(&full[s]);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r_lo = 64 * wg + 16 * warp + g;  // keys k0 + r_lo, + 8
    const int kw0 = k0 + 64 * wg;              // this warpgroup's first key

    float dk_acc[D / 2];  // dK / scale
    float dv_acc[D / 2];
    zero(dk_acc);
    zero(dv_acc);
    const uint32_t k_base = qmm::smem_u32(sK) + wg * 64 * 128;
    const uint32_t v_base = qmm::smem_u32(sV) + wg * 64 * 128;

    qmm::mbar_wait(&kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kQStages;
      const int q0 = k0 + (it % n_q) * kBQ;
      qmm::mbar_wait(&full[s], (it / kQStages) & 1);
      if (q0 + kBQ <= kw0) {  // every query before every key: all masked
        qmm::mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t q_base = qmm::smem_u32(sQ + s * TQ);
      const uint32_t do_base = qmm::smem_u32(sdO + s * TQ);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, f32,
      // in one group. (Issuing dV += P^T dO before dS^T is computed, so
      // that a second group of products with A from registers is issued
      // while the first is in flight, made the kernel 27% slower on the
      // H100; PERF.md.)
      float st[32], dpt[32];
      zero(st);
      zero(dpt);
      fence_all(st);
      fence_all(dpt);
      wgmma_begin();
      wgmma_abt<D, kBQ>(st, k_base, kPanel, q_base, kPanelQ);
      wgmma_abt<D, kBQ>(dpt, v_base, kPanel, do_base, kPanelQ);
      wgmma_end();
      fence_all(st);
      fence_all(dpt);

      // P^T = exp2(S^T scale log2 e - LSE log2 e): column 8j + 2t + e % 2
      // of the fragment is query q0 + that, row r_lo + 8 (e / 2) key k0 +
      // that. The diagonal tiles and the ragged one are masked: key >
      // query, or query at or past L.
      const bool masked = q0 < kw0 + 64 || q0 + kBQ > L;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(&sL[s][8 * jj + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          const int q = q0 + 8 * jj + 2 * t + (e & 1);
          const int key = k0 + r_lo + 8 * (e >> 1);
          float p = ex2(fmaf(st[i], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (masked && (key > q || q >= L)) p = 0.0f;
          st[i] = p;
        }
      }
      uint32_t pa[4][4];
      to_a<kBQ>(pa, st);
      // dS^T / scale = P^T * (dP^T - delta)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(&sD[s][8 * jj + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * jj + e] = st[4 * jj + e] *
                            (dpt[4 * jj + e] - ((e & 1) ? d2.y : d2.x));
      }
      uint32_t da[4][4];
      to_a<kBQ>(da, dpt);

      // dV += P^T dO and dK += dS^T Q: dO and Q read MN-major through the
      // transpose bit, 16 queries (2048 bytes) per step
      fence_all(dv_acc);
      fence_all(dk_acc);
      wgmma_begin();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<D>(dv_acc, pa[kk],
                    desc_sw128_mn(do_base + kk * 2048, kPanelQ));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<D>(dk_acc, da[kk],
                    desc_sw128_mn(q_base + kk * 2048, kPanelQ));
      wgmma_end();
      fence_all(dv_acc);
      fence_all(dk_acc);
      fence_all(pa);
      fence_all(da);
      qmm::mbar_arrive(&empty[s]);
    }

    // epilogue: dK (times scale) and dV staged in this warpgroup's own K
    // and V rows, then stored
    stage_rows<D>(sK, dk_acc, r_lo, t, scale, scale);
    stage_rows<D>(sV, dv_acc, r_lo, t, 1.0f, 1.0f);
    warpgroup_sync(wg);
    const long o_sl = static_cast<long>(Hkv) * D;
    const long off = static_cast<long>(b) * L * o_sl + hk * D;
    store_rows<D>(dk + off, o_sl, sK, wg, k0, L, tid);
    store_rows<D>(dv + off, o_sl, sV, wg, k0, L, tid);
  }
}

// a (B, L, heads, D) bf16 tensor at element strides {batch, length, head}
// as a 4-D tensor map over (d, head, row, batch), copied in boxes of 64 d x
// 1 head x `rows` rows with the 128-byte swizzle; rows past L read as zeros
inline cudaError_t encode_bhld(CUtensorMap* map, const void* base, int B,
                               int L, int heads, int D,
                               const long long* strides, int rows) {
  qmm::EncodeTiledFn fn;
  const cudaError_t err = qmm::encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the four maps of q, k, v and dO (dO null in the forward); q and dO in
// boxes of q_rows rows, k and v of kBN
inline cudaError_t encode_maps(CUtensorMap (&tm)[4], const void* q,
                               const void* k, const void* v, const void* dout,
                               int B, int L, int H, int Hkv, int D,
                               const long long* qs, const long long* ks,
                               const long long* vs, const long long* ds,
                               int q_rows) {
  cudaError_t err = encode_bhld(&tm[0], q, B, L, H, D, qs, q_rows);
  if (err == cudaSuccess)
    err = encode_bhld(&tm[1], k, B, L, Hkv, D, ks, flash::kBN);
  if (err == cudaSuccess)
    err = encode_bhld(&tm[2], v, B, L, Hkv, D, vs, flash::kBN);
  if (err == cudaSuccess && dout != nullptr)
    err = encode_bhld(&tm[3], dout, B, L, H, D, ds, q_rows);
  return err;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int L, int H, int Hkv, const long long* qs,
               const long long* ks, const long long* vs, float scale,
               cudaStream_t s) {
  CUtensorMap tm[4];
  cudaError_t err = encode_maps(tm, q, k, v, nullptr, B, L, H, Hkv, D, qs, ks,
                                vs, nullptr, flash::kBM);
  if (err == cudaSuccess) err = allow_smem(flash_fwd_kernel<D>,
                                           flash::fwd_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (L + flash::kBM - 1) / flash::kBM * B * H;
  flash_fwd_kernel<D><<<grid, flash::kThreads, flash::fwd_smem<D>(), s>>>(
      tm[0], tm[1], tm[2], static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), B, L, H, Hkv, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int L,
              int H, int Hkv, const long long* qs, const long long* ks,
              const long long* vs, const long long* ds, float scale,
              cudaStream_t s) {
  CUtensorMap tm[4];
  cudaError_t err = encode_maps(tm, q, k, v, dout, B, L, H, Hkv, D, qs, ks,
                                vs, ds, flash::kBM);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<D>,
                                           flash::dq_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (L + flash::kBM - 1) / flash::kBM * B * H;
  flash_bwd_dq_kernel<D><<<grid, flash::kThreads, flash::dq_smem<D>(), s>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), B,
      L, H, Hkv, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int L, int H, int Hkv, const long long* qs,
               const long long* ks, const long long* vs, const long long* ds,
               float scale, cudaStream_t s) {
  CUtensorMap tm[4];
  cudaError_t err = encode_maps(tm, q, k, v, dout, B, L, H, Hkv, D, qs, ks,
                                vs, ds, flash::kBQ);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkv_kernel<D>,
                                           flash::dkv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (L + flash::kBN - 1) / flash::kBN * B * Hkv;
  flash_bwd_dkv_kernel<D>
      <<<grid, flash::kThreads, flash::dkv_smem<D>(), s>>>(
          tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), B, L, H, Hkv, scale,
          scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All three launch on `stream` and return cudaGetLastError() (0 on
// success); 1 (cudaErrorInvalidValue) for a head_dim other than 64 or 128.
// q, k, v, dO: bf16 (B, L, heads, D), 16-byte aligned, D contiguous, every
// other stride (elements, given as {batch, length, head}) a multiple of 8.
// H % Hkv == 0. o, dq: (B, L, H, D) bf16 contiguous; dk, dv: (B, L, Hkv, D)
// bf16 contiguous; lse, delta: (B, H, L) f32 contiguous.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int L, int H,
                                int Hkv, int D, const long long* q_strides,
                                const long long* k_strides,
                                const long long* v_strides, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, L, H, Hkv, q_strides,
                           k_strides, v_strides, scale, s);
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, L, H, Hkv, q_strides,
                          k_strides, v_strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int L, int H, int Hkv,
                                   int D, const long long* q_strides,
                                   const long long* k_strides,
                                   const long long* v_strides,
                                   const long long* do_strides, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, L, H, Hkv,
                          q_strides, k_strides, v_strides, do_strides, scale,
                          s);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, L, H, Hkv,
                         q_strides, k_strides, v_strides, do_strides, scale,
                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int L, int H,
                                    int Hkv, int D,
                                    const long long* q_strides,
                                    const long long* k_strides,
                                    const long long* v_strides,
                                    const long long* do_strides, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, L, H, Hkv,
                           q_strides, k_strides, v_strides, do_strides, scale,
                           s);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, L, H, Hkv,
                          q_strides, k_strides, v_strides, do_strides, scale,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
