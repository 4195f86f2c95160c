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
// What the design does about that bound:
//   - Causally dead tiles are never visited: a query tile loops over key
//     tiles up to the diagonal, a key tile over query tiles from it on; only
//     the diagonal tile pays for the mask (keys past L lie past every valid
//     row). Query tiles are scheduled longest first (the diagonal makes
//     later tiles longer), to shorten the tail of the grid. Softmax
//     statistics stay in f32 (exp2 with the scale folded in).
//   - Forward (flash_fwd_kernel), on wgmma + TMA: one block per (128-row
//     query tile, query head, batch), the G query heads of one KV head on
//     adjacent blocks so their K/V tiles are L2 hits. One producer thread
//     loads the Q tile once and keeps a ring of 128-key K and V tiles in
//     flight by TMA (4-D tensor maps over the strided (B, L, heads, D)
//     layout, 128-byte swizzle, full/empty mbarrier pairs); two consumer
//     warpgroups (setmaxnreg gives them the registers) own 64 query rows
//     each: S = Q K^T is wgmma m64n128k16 with both operands in shared
//     memory, the online softmax runs on the f32 accumulator fragments, and
//     O += P V takes P from registers (rounded to bf16 in place) and V from
//     shared memory through the instruction's transpose bit. The two
//     warpgroups run unsynchronised, so one's softmax overlaps the other's
//     products. The epilogue rounds O / l once to bf16, stages it in the
//     warpgroup's own Q rows and writes 16-byte stores. Each output row is
//     reduced in one block in a fixed order: deterministic.
//   - Backward, on mma.sync m16n8k16 with f32 accumulators (64-row tiles, 4
//     warps): P and dS go from accumulator registers straight into A
//     fragments; K, V, Q and dO tiles are double-buffered through cp.async;
//     V, K, dO and Q in the "transposed" operand role come through
//     ldmatrix.trans. dK/dV: one block per (batch, KV head, 64-key tile)
//     loops over the G query heads of its group and every live query tile,
//     summing dK and dV in registers: no atomics, deterministic. dQ: one
//     block per (batch, query head, 64-row tile): also no atomics.
// The mma.sync forward that the wgmma one replaced took 0.379 ms at the
// training shapes, 2.45x SDPA (NVIDIA H100 80GB HBM3, 700 W).

#include "mma_util.cuh"
#include "qmm_wgmma.cuh"

namespace {

using port::ld_u32;
using port::mma_bf16;
using port::pack_bf16;

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Geo {
  static constexpr int kStride = D + 8;               // bf16 per smem row
  static constexpr int kTileElems = kTile * kStride;  // one 64-row tile
};

// Copy rows [r0, r0 + 64) of one head of a (B, L, heads, D) tensor into a
// [64][D + 8] smem tile; rows at or past L are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long s_l, int r0, int L, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte copies per row
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = r0 + r;
    const __nv_bfloat16* src =
        base + static_cast<long>(row < L ? row : L - 1) * s_l + c * 8;
    port::cp_async16(dst + r * Geo<D>::kStride + c * 8, src,
                     row < L ? 16 : 0);
  }
}

// C[16 x 64] += A[16 rows of a_tile] * B^T where B is a [64][D] smem tile
// used as the (k = d, n = row of b_tile) operand: S = Q K^T, dP = dO V^T.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4],
                                        const __nv_bfloat16* a_tile,
                                        int a_row0,
                                        const __nv_bfloat16* b_tile, int g,
                                        int t) {
  constexpr int S = Geo<D>::kStride;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* ap = a_tile + (a_row0 + g) * S + kk * 16 + 2 * t;
    uint32_t a[4];
    a[0] = ld_u32(ap);
    a[1] = ld_u32(ap + 8 * S);
    a[2] = ld_u32(ap + 8);
    a[3] = ld_u32(ap + 8 * S + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* bp = b_tile + (nt * 8 + g) * S + kk * 16 + 2 * t;
      mma_bf16(c[nt], a, ld_u32(bp), ld_u32(bp + 8));
    }
  }
}

// acc[16 x D] += P[16 x 64] * V where P is held as 8 f32 C tiles and V is a
// [64][D] smem tile used as the (k = row, n = d) operand through
// ldmatrix.trans: O += P V, dV += P^T dO, dQ += dS K, dK += dS^T Q.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const float (&p)[8][4],
                                       const __nv_bfloat16* v_tile,
                                       int lane) {
  constexpr int S = Geo<D>::kStride;
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* row =
        v_tile + (kk * 16 + (lane & 7) + (mi & 1) * 8) * S + (mi >> 1) * 8;
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b[4];
      port::ldmatrix_x4_trans(b, row + dt * 8);
      mma_bf16(acc[dt], a, b[0], b[1]);
      mma_bf16(acc[dt + 1], a, b[2], b[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
}

__device__ __forceinline__ void zero8(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
}

// Store a warp's 16 x D accumulator rows [row0, row0 + 16) (times `mul`) as
// bf16 into a contiguous (.., D) head slice with row stride `s_l`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long s_l,
                                           int row0, int L,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, int g,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    if (row >= L) continue;
    const float mul = half ? mul1 : mul0;
    __nv_bfloat16* dst = base + static_cast<long>(row) * s_l + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * half] * mul, acc[dt][2 * half + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------- forward
// flash_fwd_kernel: one block per (128-row query tile, query head, batch) on
// wgmma + TMA (see the file comment). Shared memory holds the Q tile and a
// ring of kStages K and V tiles, each a 128-row tile in D / 64 panels of
// 64 columns (128 bytes per row, 128-byte swizzle, 16 KB per panel), as TMA
// writes them and the wgmma descriptors read them.
namespace fwd {

constexpr int kBM = 128;            // query rows per block: 2 x 64
constexpr int kBN = 128;            // keys per tile
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kStages = 2;          // K/V ring depth
constexpr int kPanel = 128 * 128;   // bytes of one 64-column panel of a tile

template <int D>
__host__ __device__ constexpr int tile_bytes() { return (D / 64) * kPanel; }
template <int D>
__host__ __device__ constexpr int smem_bytes() {  // Q, the ring, alignment
  return (1 + 2 * kStages) * tile_bytes<D>() + 1024;
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O (64 x D) += P (64 x 16 keys, registers) . V (16 keys x D)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[4],
                                         uint64_t desc_v);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&p)[4],
                                              uint64_t desc_v) {
  wgmma_m64n128k16_rs_tb(o, p, desc_v);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&p)[4],
                                             uint64_t desc_v) {
  wgmma_m64n64k16_rs_tb(o, p, desc_v);
}

}  // namespace fwd

template <int D>
__global__ void __launch_bounds__(fwd::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int B, int L, int H, int Hkv, float scale_log2) {
  using namespace fwd;
  constexpr int P = D / 64;            // 64-column panels per tile
  constexpr int T = tile_bytes<D>();   // bytes of one 128-row tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start there
  uint8_t* sQ =
      smem_raw + ((1024 - (qmm::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + T;             // kStages tiles
  uint8_t* sV = sK + kStages * T;   // kStages tiles

  // block -> (query tile, batch, KV head, query head of its group): the
  // longest (latest) query tiles first, the G query heads of one KV head on
  // adjacent blocks (their K/V tiles are L2 hits)
  const int G = H / Hkv;
  const int n_qt = (L + kBM - 1) / kBM;
  int idx = blockIdx.x;
  const int hg = idx % G;
  idx /= G;
  const int hk = idx % Hkv;
  idx /= Hkv;
  const int b = idx % B;
  const int qt = n_qt - 1 - idx / B;
  const int h = hk * G + hg;
  const int q0 = qt * kBM;
  const int n_kt = qt + 1;  // key tiles up to the diagonal (kBN == kBM)

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
#pragma unroll
      for (int p = 0; p < P; ++p)
        tma_load_4d(sQ + p * kPanel, &tm_q, &q_full, 64 * p, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) qmm::mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        qmm::mbar_expect_tx(&k_full[s], T);
#pragma unroll
        for (int p = 0; p < P; ++p)
          tma_load_4d(sK + s * T + p * kPanel, &tm_k, &k_full[s], 64 * p, hk,
                      j * kBN, b);
        qmm::mbar_expect_tx(&v_full[s], T);
#pragma unroll
        for (int p = 0; p < P; ++p)
          tma_load_4d(sV + s * T + p * kPanel, &tm_v, &v_full[s], 64 * p, hk,
                      j * kBN, b);
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
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
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
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
      qmm::mbar_wait(&k_full[s], ph);
#pragma unroll
      for (int i = 0; i < 64; ++i) qmm::fence_operand(sc[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // +16 KB per 64-column panel, +32 bytes per k16 step inside it
        const uint32_t off = (kk / 4) * kPanel + (kk % 4) * 32;
        wgmma_m64n128k16_ss(sc, qmm::desc_sw128(q_base + off),
                            qmm::desc_sw128(k_base + off));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) qmm::fence_operand(sc[i]);

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
      // P as A fragments, in place: keys 16kk .. 16kk + 15 are accumulator
      // columns j = 2kk and 2kk + 1
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = qmm::pack2(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = qmm::pack2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = qmm::pack2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = qmm::pack2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: V read MN-major through the transpose bit, 16 keys
      // (2048 bytes) per step, panels kPanel bytes apart
      qmm::mbar_wait(&v_full[s], ph);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) qmm::fence_operand(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<D>(acc, pa[kk], desc_sw128_mn(v_base + kk * 2048, kPanel));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < D / 2; ++i) qmm::fence_operand(acc[i]);
      qmm::mbar_arrive(&empty[s]);
    }

    // epilogue: O / l rounded once to bf16, staged in this warpgroup's own
    // (now unread) Q rows in the same swizzled layout, then 16-byte stores
    // of the rows below L; LSE = m + log(l), natural log
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
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r_lo + 8 * hr;
        uint8_t* dst = sQ + (jj / 8) * kPanel + r * 128 +
                       ((((jj % 8) ^ r) & 7) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(dst) =
            qmm::pack2(acc[4 * jj + 2 * hr] * inv[hr],
                       acc[4 * jj + 2 * hr + 1] * inv[hr]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    const long o_sl = static_cast<long>(H) * D;
    __nv_bfloat16* ob = o + static_cast<long>(b) * L * o_sl + h * D;
    for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
      const int r = 64 * wg + i / (D / 8);
      const int c = i % (D / 8);  // 16-byte chunk of the row
      const int row = q0 + r;
      if (row >= L) continue;
      const uint8_t* src =
          sQ + (c / 8) * kPanel + r * 128 + ((((c % 8) ^ r) & 7) << 4);
      *reinterpret_cast<uint4*>(ob + row * o_sl + c * 8) =
          *reinterpret_cast<const uint4*>(src);
    }
  }
}
// ------------------------------------------------------------------ dQ
// grid (n_qtiles, H, B); smem: Q and dO tiles, K and V double-buffered.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int L, int H, int Hkv,
                    long q_sb, long q_sl, long q_sh, long k_sb, long k_sl,
                    long k_sh, long v_sb, long v_sl, long v_sh, long d_sb,
                    long d_sl, long d_sh, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = Geo<D>::kTileElems;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + T;
  __nv_bfloat16* sK = sdO + T;     // 2 buffers
  __nv_bfloat16* sV = sK + 2 * T;  // 2 buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kTile;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* db = dout + b * d_sb + h * d_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  load_tile<D>(sQ, qb, q_sl, q0, L, tid);
  load_tile<D>(sdO, db, d_sl, q0, L, tid);
  load_tile<D>(sK, kb, k_sl, 0, L, tid);
  load_tile<D>(sV, vb, v_sl, 0, L, tid);
  port::cp_async_commit();

  const int row_a = q0 + warp * 16 + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_a + hr * 8;
    const long i = (static_cast<long>(b) * H + h) * L + row;
    lse2[hr] = row < L ? lse[i] * kLog2e : 0.0f;
    dlt[hr] = row < L ? delta[i] : 0.0f;
  }

  float acc[D / 8][4];
  zero_acc<D>(acc);
  const int n_kt = qt + 1;
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      const int nb = (j + 1) & 1;
      load_tile<D>(sK + nb * T, kb, k_sl, (j + 1) * kTile, L, tid);
      load_tile<D>(sV + nb * T, vb, v_sl, (j + 1) * kTile, L, tid);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + (j & 1) * T;
    const __nv_bfloat16* tV = sV + (j & 1) * T;
    const int k0 = j * kTile;

    float p[8][4];
    zero8(p);
    mma_abt<D>(p, sQ, warp * 16, tK, g, t);
    float dp[8][4];
    zero8(dp);
    mma_abt<D>(dp, sdO, warp * 16, tV, g, t);

    const bool edge = (j == qt) || (k0 + kTile > L);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float pe = exp2f(p[nt][e] * scale_log2 - lse2[hr]);
        if (edge) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          if (key > row_a + hr * 8 || key >= L) pe = 0.0f;
        }
        p[nt][e] = pe * (dp[nt][e] - dlt[hr]);  // dS / scale
      }
    }
    mma_pv<D>(acc, p, tK, lane);
    __syncthreads();
  }
  const long o_sl = static_cast<long>(H) * D;
  __nv_bfloat16* out = dq + static_cast<long>(b) * L * o_sl + h * D;
  store_rows<D>(out, o_sl, q0 + warp * 16, L, acc, scale, scale, g, t);
}

// --------------------------------------------------------------- dK / dV
// grid (n_ktiles, Hkv, B); smem: K and V tiles, Q and dO double-buffered,
// LSE and delta rows per query tile. Warp w owns keys k0 + 16w .. + 15.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int L, int H, int Hkv,
                     long q_sb, long q_sl, long q_sh, long k_sb, long k_sl,
                     long k_sh, long v_sb, long v_sl, long v_sh, long d_sb,
                     long d_sl, long d_sh, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = Geo<D>::kTileElems;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + T;
  __nv_bfloat16* sQ = sV + T;       // 2 buffers
  __nv_bfloat16* sdO = sQ + 2 * T;  // 2 buffers
  float* sL = reinterpret_cast<float*>(sdO + 2 * T);  // [2][64] lse
  float* sD = sL + 2 * kTile;                          // [2][64] delta

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kt = blockIdx.x;  // the diagonal makes early key tiles longest
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int k0 = kt * kTile;
  const int n_qt = (L + kTile - 1) / kTile;
  const int nq = n_qt - kt;  // live query tiles per head
  const int n_it = G * nq;

  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  auto load_q_stage = [&](int it, int buf) {
    const int h = hk * G + it / nq;
    const int q0 = (kt + it % nq) * kTile;
    load_tile<D>(sQ + buf * T, q + b * q_sb + h * q_sh, q_sl, q0, L, tid);
    load_tile<D>(sdO + buf * T, dout + b * d_sb + h * d_sh, d_sl, q0, L,
                 tid);
    // one f32 of lse or delta per thread; rows past L are zero-filled
    const int r = tid & (kTile - 1);
    const int row = q0 + r;
    const long i = (static_cast<long>(b) * H + h) * L + (row < L ? row : 0);
    if (tid < kTile) {
      port::cp_async4(sL + buf * kTile + r, lse + i, row < L ? 4 : 0);
    } else {
      port::cp_async4(sD + buf * kTile + r, delta + i, row < L ? 4 : 0);
    }
  };

  load_tile<D>(sK, kb, k_sl, k0, L, tid);
  load_tile<D>(sV, vb, v_sl, k0, L, tid);
  load_q_stage(0, 0);
  port::cp_async_commit();

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
  zero_acc<D>(dk_acc);
  zero_acc<D>(dv_acc);
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, +8

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_q_stage(it + 1, (it + 1) & 1);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1;
    const __nv_bfloat16* tQ = sQ + buf * T;
    const __nv_bfloat16* tdO = sdO + buf * T;
    const float* tL = sL + buf * kTile;
    const float* tD = sD + buf * kTile;
    const int q0 = (kt + it % nq) * kTile;

    // S^T (16 keys x 64 queries) and P^T
    float p[8][4];
    zero8(p);
    mma_abt<D>(p, sK, warp * 16, tQ, g, t);
    const bool edge = (q0 == k0) || (q0 + kTile > L);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);  // query within the tile
        float pe = exp2f(p[nt][e] * scale_log2 - tL[ql] * kLog2e);
        if (edge) {
          const int key = key_a + (e >= 2 ? 8 : 0);
          if (key > q0 + ql || q0 + ql >= L) pe = 0.0f;
        }
        p[nt][e] = pe;
      }
    }
    mma_pv<D>(dv_acc, p, tdO, lane);  // dV += P^T dO

    float dp[8][4];  // dP^T = V dO^T (16 keys x 64 queries)
    zero8(dp);
    mma_abt<D>(dp, sV, warp * 16, tdO, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        dp[nt][e] = p[nt][e] * (dp[nt][e] - tD[ql]);  // dS^T / scale
      }
    }
    mma_pv<D>(dk_acc, dp, tQ, lane);  // dK += dS^T Q
    __syncthreads();
  }

  const long o_sl = static_cast<long>(Hkv) * D;
  const long off = static_cast<long>(b) * L * o_sl + hk * D;
  store_rows<D>(dk + off, o_sl, k0 + warp * 16, L, dk_acc, scale, scale, g,
                t);
  store_rows<D>(dv + off, o_sl, k0 + warp * 16, L, dv_acc, 1.0f, 1.0f, g, t);
}

template <int D>
constexpr int dq_smem() { return 6 * Geo<D>::kTileElems * 2; }
template <int D>
constexpr int dkv_smem() {
  return 6 * Geo<D>::kTileElems * 2 + 4 * kTile * 4;
}

// a (B, L, heads, D) bf16 tensor at element strides {batch, length, head}
// as a 4-D tensor map over (d, head, row, batch), copied in boxes of 64 d x
// 1 head x 128 rows with the 128-byte swizzle; rows past L read as zeros
inline cudaError_t encode_bhld(CUtensorMap* map, const void* base, int B,
                               int L, int heads, int D,
                               const long long* strides) {
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
  const cuuint32_t box[4] = {64, 1, fwd::kBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int L, int H, int Hkv, const long long* qs,
               const long long* ks, const long long* vs, float scale,
               cudaStream_t s) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_bhld(&tm_q, q, B, L, H, D, qs);
  if (err == cudaSuccess) err = encode_bhld(&tm_k, k, B, L, Hkv, D, ks);
  if (err == cudaSuccess) err = encode_bhld(&tm_v, v, B, L, Hkv, D, vs);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = flash_fwd_kernel<D>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fwd::smem_bytes<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (L + fwd::kBM - 1) / fwd::kBM * B * H;
  kern<<<grid, fwd::kThreads, fwd::smem_bytes<D>(), s>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), B, L, H, Hkv, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int L,
              int H, int Hkv, const long long* qs, const long long* ks,
              const long long* vs, const long long* ds, float scale,
              cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, dq_smem<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), L, H, Hkv, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], ds[0], ds[1], ds[2], scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int L, int H, int Hkv, const long long* qs,
               const long long* ks, const long long* vs, const long long* ds,
               float scale, cudaStream_t s) {
  auto kern = flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, Hkv, B);
  kern<<<grid, kThreads, dkv_smem<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), L, H,
      Hkv, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      ds[0], ds[1], ds[2], scale, scale * kLog2e);
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
