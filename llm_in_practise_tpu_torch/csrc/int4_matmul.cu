// W4A16 int4 dequant-matmul for Hopper (sm_90a), forward and backward:
//   y  = x  @ W     (qmm_wgmma_kernel<Int4Fwd> at prefill and training row
//                    counts; int4_thin_kernel at decode row counts)
//   dx = dy @ W^T   (qmm_wgmma_kernel<Int4Dx>)
// with W[k, n] = (code[k, n] - zero[k / gs, n]) * scale[k / gs, n].
//
// Replaces the TPU kernels llm_in_practise_tpu/ops/int4_matmul.py::_fwd_kernel
// (launched by _int4_matmul_fwd through pl.pallas_call) and ::_bwd_kernel
// (_int4_matmul_bwd). They compute the same functions with the same rounding
// points, and are not carried over block by block: the TPU kernels split x
// into even and odd K columns outside the kernel and return dx as two halves
// interleaved afterwards, because Mosaic cannot unpack adjacent-K nibble
// pairs; here the pairing is what the tensor cores want.
//   - W is an Int4Tensor: packed (K/2, N) uint8 where byte [i, n] holds the
//     codes of K rows 2i (high nibble) and 2i + 1 (low nibble) of column n;
//     scales and zeros (K/gs, N) f32 (zeros may be fractional); groups of gs
//     rows run along K.
//   - x and dy are bf16 (the wrapper casts); each weight is (code - zero) *
//     scale in f32, rounded once to bf16; products accumulate in f32; the
//     output is written in the caller's dtype.
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16): at decode
// (M <= 8) the forward is bound by bytes, 0.5 byte of codes plus 8/gs bytes
// of scale and zero per weight (0.5625 B at gs 128); at training widths
// (M = 8192) both directions are bound by the 2*M*K*N tensor-core
// operations (3.196 ms for one Qwen3-8B layer's 7 projections).
//
// What the design does about that bound:
//   - Both directions at large M run on the shared wgmma mainloop of
//     qmm_wgmma.cuh (TMA ring, one producer thread, two consumer
//     warpgroups on a 128 x 256 tile of the transposed output, reducing in
//     the block: deterministic), with the weight decoded from staged bytes
//     straight into register A fragments: the bf16 weight never exists in
//     device or shared memory.
//   - Forward (Int4Fwd), y^T = W^T . x^T: one packed byte holds rows k and
//     k + 1 of one column, which is exactly one A register; the chunk's
//     group rows of scales and zeros are staged in the ring beside the
//     codes (1 row at gs >= 64, 64 / gs below). The mma.sync design it
//     replaced at these row counts (64 x 64 tiles, 4 warps, cp.async ring,
//     scale and zero reloaded through L1 whenever the group changed) took
//     22.95 ms for one layer's 7 projections at M = 8192, 5.8x cuBLAS on a
//     dequantized weight (NVIDIA H100 80GB HBM3, 700 W).
//   - Thin M (decode) leaves a 256-row tile mostly empty and too few blocks
//     to fill 132 SMs: int4_thin_kernel (below) streams long runs of packed
//     rows through a warp-specialized TMA ring, decodes on mma.sync with
//     the weight as the A operand (8 rows of x fill an n8 tile), and sums
//     the K splits of a column slab inside a thread-block cluster through
//     distributed shared memory: one launch, no workspace, deterministic.
//     The wrapper picks the route by shape (ops/int4_matmul.py::_route).
//     The split-K mma.sync kernel it replaced (16-row tiles, f32 partials
//     in device memory summed by a second launch) took 0.204 ms of device
//     time for one layer's 7 projections at M = 8 (NVIDIA H100 80GB HBM3,
//     700 W).
//   - Backward (Int4Dx), dx^T = W . dy^T: the group is constant along the
//     reduction, so each thread's scale/zero row is fixed, and the scales
//     and zeros of the block's groups are staged in the ring beside the
//     codes (512 bytes per stage at gs 128). One 16-bit load of bytes
//     (n, n + 1) of packed row i gives the A pair of dx column 2i (high
//     nibbles) and of 2i + 1 (low nibbles): fragment rows g and g + 8 are
//     mapped to those two columns and the epilogue undoes it. The mma.sync
//     design it replaced took 25.49 ms for one layer's 7 projections at
//     M = 8192, 6.5x cuBLAS on a dequantized weight (NVIDIA H100 80GB HBM3,
//     700 W).
//   - The dequant uses __fsub_rn/__fmul_rn so nvcc cannot contract it into
//     an FMA, which would round differently from the reference codec.
//   - The M, N and K edges are masked (TMA's zero fill, or zeros written
//     by the thin kernel's producer warp, and guarded stores).

#include "qmm_wgmma.cuh"
#include "mma_util.cuh"

namespace {

using port::mma_bf16;
using bf16 = __nv_bfloat16;

// B7's decode policy for the quantized-matmul mainloop (qmm_wgmma.cuh), as
// dx^T = W . dy^T. The weight tile
// is 64 packed rows x 64 bytes (TMA, 64-byte swizzle), i.e. dx columns
// k0 .. k0 + 127; then the g_rows group rows of scales and of zeros that
// cover those columns, 64 f32 columns each (zero past N and past the last
// group). Thread g of warp w in warpgroup wg reads packed row
// P = 32 wg + 8 w + g: fragment row g is dx column k0 + 2P (high nibbles),
// row g + 8 is k0 + 2P + 1 (low nibbles), one group for both (gs is even).
struct Int4Dx : qmm::LinearChunks, qmm::LinearCols {
  static constexpr uint32_t kWBytes = (qmm::kTileCols / 2) * qmm::kChunk;

  __device__ static uint32_t tx_bytes(const qmm::QmmArgs& args) {
    return kWBytes + 2 * args.g_rows * qmm::kChunk * 4;
  }

  __device__ static void load(uint8_t* w, const CUtensorMap* tm_packed,
                              const CUtensorMap* tm_scales,
                              const CUtensorMap* tm_zeros, uint64_t* bar,
                              int i, int k0, const qmm::QmmArgs& args) {
    const int c0 = i * qmm::kChunk;
    const int g0 = k0 / args.gs;
    uint8_t* aux = w + kWBytes;
    qmm::tma_load_2d(w, tm_packed, bar, c0, k0 / 2);
    qmm::tma_load_2d(aux, tm_scales, bar, c0, g0);
    qmm::tma_load_2d(aux + args.g_rows * qmm::kChunk * 4, tm_zeros, bar, c0,
                     g0);
  }

  __device__ static int col_local(int wg, int warp, int g, int hi) {
    return 64 * wg + 16 * warp + 2 * g + hi;
  }

  // (code - zero) * scale in f32, each step rounded on its own (no FMA
  // contraction), as the codec does; 2^23 + code, less 2^23, is the code
  // exactly
  static __device__ __forceinline__ float deq(uint32_t code, float zero,
                                              float scale) {
    const float c = __uint_as_float(0x4B000000u | code) - 8388608.0f;
    return __fmul_rn(__fsub_rn(c, zero), scale);
  }

  struct State {
    int prow, t, sc_off, zr_off;
    __device__ State(const qmm::QmmArgs& args, int k0, int wg, int warp,
                     int g, int t_)
        : prow(32 * wg + 8 * warp + g), t(t_) {
      // a packed row past K (zero codes, its dx never stored) may lie past
      // the staged groups when g_rows was cut to n_groups: clamp it
      const int grp = min((k0 + 2 * prow) / args.gs - k0 / args.gs,
                          args.g_rows - 1);
      sc_off = grp * qmm::kChunk;
      zr_off = (args.g_rows + grp) * qmm::kChunk;
    }

    // bytes (n, n + 1) of the packed row: high nibbles give fragment row g,
    // low nibbles row g + 8
    __device__ void decode(const uint8_t* w, const float* aux, int, int ks,
                           uint32_t (&a)[4]) const {
      const int c = 16 * ks + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // columns c, c + 1, then c + 8, c + 9
        const int n = c + 8 * h;
        const uint32_t b = *reinterpret_cast<const uint16_t*>(
            w + qmm::sw64(prow, n));
        const float2 s = *reinterpret_cast<const float2*>(aux + sc_off + n);
        const float2 z = *reinterpret_cast<const float2*>(aux + zr_off + n);
        a[2 * h] = qmm::pack2(deq((b >> 4) & 15, z.x, s.x),
                              deq((b >> 12) & 15, z.y, s.y));
        a[2 * h + 1] = qmm::pack2(deq(b & 15, z.x, s.x),
                                  deq((b >> 8) & 15, z.y, s.y));
      }
    }
  };
};
// B6's decode policy for the same mainloop at prefill and training row
// counts, as y^T = W^T . x^T: A is W^T, its rows the output columns n, its
// reduction k. A stage holds 64 k: 32 packed rows x 128 bytes (TMA,
// 128-byte swizzle) for output columns n0 .. n0 + 127, then the g_rows
// group rows of scales and of zeros that cover those 64 k, 128 f32 columns
// each. One packed byte holds the adjacent-K pair (2 kp, 2 kp + 1) of one
// column, which is exactly one A register: fragment rows g and g + 8 of
// warp w in warpgroup wg are the adjacent columns n0 + C and n0 + C + 1,
// C = 64 wg + 16 w + 2 g, so one 16-bit load of bytes (C, C + 1) of packed
// row kp gives a[0] and a[1], and packed row kp + 4 gives a[2] and a[3].
// A thread's two columns are fixed; only the group row varies, with the
// stage and the k16 step. Group sizes: a multiple of 64 (one group row per
// stage) or a divisor of 64 (64 / gs rows); the wrapper routes the others
// to the thin-M kernel.
struct Int4Fwd : qmm::LinearChunks, qmm::LinearCols {
  static constexpr uint32_t kWBytes = (qmm::kChunk / 2) * qmm::kTileCols;

  __device__ static uint32_t tx_bytes(const qmm::QmmArgs& args) {
    return kWBytes + 2 * args.g_rows * qmm::kTileCols * 4;
  }

  __device__ static void load(uint8_t* w, const CUtensorMap* tm_packed,
                              const CUtensorMap* tm_scales,
                              const CUtensorMap* tm_zeros, uint64_t* bar,
                              int i, int n0, const qmm::QmmArgs& args) {
    const int k0 = i * qmm::kChunk;
    const int g0 = k0 / args.gs;
    uint8_t* aux = w + kWBytes;
    qmm::tma_load_2d(w, tm_packed, bar, n0, k0 / 2);
    qmm::tma_load_2d(aux, tm_scales, bar, n0, g0);
    qmm::tma_load_2d(aux + args.g_rows * qmm::kTileCols * 4, tm_zeros, bar,
                     n0, g0);
  }

  __device__ static int col_local(int wg, int warp, int g, int hi) {
    return 64 * wg + 16 * warp + 2 * g + hi;
  }

  struct State {
    int col, t, lg, last, zr_off;
    __device__ State(const qmm::QmmArgs& args, int, int wg, int warp, int g,
                     int t_)
        : col(64 * wg + 16 * warp + 2 * g),
          t(t_),
          lg(0),
          // a k past K (zero x) may lie past the staged group rows when
          // g_rows was cut to n_groups: clamp it
          last(args.g_rows - 1),
          zr_off(args.g_rows * qmm::kTileCols) {
      // k offset in the stage >> lg is the staged group row: log2(gs)
      // below 64, 6 (always row 0) from 64 up
      for (int v = min(args.gs, qmm::kChunk); v > 1; v >>= 1) ++lg;
    }

    __device__ void decode(const uint8_t* w, const float* aux, int, int ks,
                           uint32_t (&a)[4]) const {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // k 16 ks + 2t (+1), then the same + 8
        const int kp = 8 * ks + t + 4 * h;
        const uint32_t b = *reinterpret_cast<const uint16_t*>(
            w + qmm::sw128(kp, col));
        const int grp = min((16 * ks + 2 * t + 8 * h) >> lg, last);
        const int o = grp * qmm::kTileCols + col;
        const float2 s = *reinterpret_cast<const float2*>(aux + o);
        const float2 z = *reinterpret_cast<const float2*>(aux + zr_off + o);
        a[2 * h] = qmm::pack2(Int4Dx::deq((b >> 4) & 15, z.x, s.x),
                              Int4Dx::deq(b & 15, z.x, s.x));
        a[2 * h + 1] = qmm::pack2(Int4Dx::deq((b >> 12) & 15, z.y, s.y),
                                  Int4Dx::deq((b >> 8) & 15, z.y, s.y));
      }
    }
  };
};

// ---------------------------------------------------------------- thin M
// B6's route for decode row counts (int4_thin_kernel), y^T = W^T . x^T on
// mma.sync m16n8k16: A is the weight (16 output columns x 16 k, decoded from
// the packed bytes into registers), B is x^T (16 k x 8 rows of x), so 8 rows
// of x fill an n8 tile and no tensor-core row is padding at M = 8.
//   - A block owns a slab of kBN = 128 output columns and one of `splits`
//     runs of K; the splits of one slab are one thread-block cluster.
//   - One producer warp streams the block's run through a ring of stages
//     of kKC = 128 k (64 packed rows x 128 bytes of codes, the x tile, and
//     the group rows of scales and zeros that cover the stage) behind
//     full/empty mbarrier pairs: by TMA where the shape allows it (K % 8 and
//     N % 16 zero, gs a power of two from 16 up), otherwise by plain loads
//     into the same layout. Eight consumer warps decode and multiply
//     without block-wide barriers, so a block keeps several stages in
//     flight while it decodes.
//   - Consumer warp w decodes columns 32 (w % 4) .. + 31 over k-steps
//     4 (w / 4) .. + 3 of each stage. Thread (g, t) owns the 4 adjacent
//     columns 4g .. 4g + 3 of its warp's 32: A tile a takes fragment rows g
//     and g + 8 from columns 4g + 2a and 4g + 2a + 1, so one 32-bit load of
//     packed row kp gives a[0] and a[1] of both tiles and packed row kp + 4
//     gives a[2] and a[3]; the scales and zeros of the 4 columns are one
//     16-byte load each.
//   - Each weight is (code - zero) * scale in f32 with each step rounded
//     on its own, as the codec does, and one rounding to bf16 per pair. A
//     word's 8 nibbles become 8 exact floats 2^23 + code with two masks, a
//     shift and one byte permute each.
//   - The reduction stays on chip and in a fixed order: a block adds its
//     two k halves in shared memory and stores each column quad's f32 sums
//     into the receive buffer of the cluster block that owns the quad,
//     through distributed shared memory; after one cluster barrier each
//     block sums its share over the splits in split order and writes the
//     output dtype. One launch, no workspace in device memory,
//     deterministic.
namespace thin {

constexpr int kConsumers = 256;       // 8 warps: 4 column groups x 2 k halves
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBN = 128;              // output columns per block
constexpr int kKC = 128;              // k per stage: 64 packed rows
constexpr int kCodeBytes = (kKC / 2) * kBN;  // 128-byte swizzled rows
constexpr int kMaxSplits = 8;         // portable cluster size
constexpr int kMaxStages = 6;
constexpr uint32_t kMagic = 0x4B000000u;  // 2^23 as f32 bits

template <int MT>  // n8 tiles of x rows per block: 8 MT rows
struct Geo {
  static constexpr int kRows = 8 * MT;
  static constexpr int kStages = MT <= 2 ? 6 : MT <= 4 ? 4 : 3;
  static constexpr int kMinBlocks = MT <= 2 ? 3 : MT <= 4 ? 2 : 1;
  // x: two boxes of 64 k (128-byte swizzled rows), one per k half
  static constexpr int kXBytes = 2 * kRows * 128;
  // the receive buffer: every split's sums of this block's share of the
  // slab, kRows rows x at most kBN / 4 / splits + 1 column quads x splits
  static constexpr int kRecvBytes = kRows * (kBN / 4 + kMaxSplits) * 16;
};

// group rows of scales (and as many of zeros) staged per stage on the TMA
// path (gs a power of two): those that cover kKC k from a multiple of kKC
__host__ __device__ inline int staged_group_rows(int gs, int n_groups) {
  const int rows = gs >= kKC ? 1 : kKC / gs;
  return rows < n_groups ? rows : n_groups;
}

// bytes of one stage, a multiple of 1024 (the swizzle's period)
template <int MT>
__host__ __device__ inline int stage_bytes(int g_rows) {
  return (kCodeBytes + Geo<MT>::kXBytes + 2 * g_rows * kBN * 4 + 1023) /
         1024 * 1024;
}

// the ring, then the receive buffer (other blocks of the cluster write it
// while this one may still stream), and 1024 for the alignment
template <int MT>
__host__ __device__ inline int smem_bytes(int g_rows) {
  return Geo<MT>::kStages * stage_bytes<MT>(g_rows) + Geo<MT>::kRecvBytes +
         1024;
}

// the first column quad of cluster block `rank`'s share of the slab
__device__ __forceinline__ int quad_lo(int rank, int splits) {
  return rank * (kBN / 4) / splits;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four f32 to `p` in the shared memory of cluster block `rank`
__device__ __forceinline__ void st_dsmem4(float* p, uint32_t rank,
                                          float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(qmm::smem_u32(p)), "r"(rank));
  asm volatile(
      "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
      : "memory");
}

// (code - zero) * scale for the code in byte `i` of `nib` (0 .. 15 per
// byte), each step rounded in f32 as the codec does: the bits 2^23 + code
// are an exact f32, less 2^23 the code itself
__device__ __forceinline__ float deq_code(uint32_t nib, int i, float zero,
                                          float scale) {
  const float m = __uint_as_float(__byte_perm(nib, kMagic, 0x7650 + i));
  return __fmul_rn(__fsub_rn(__fsub_rn(m, 8388608.0f), zero), scale);
}

// A register of weight column `i` (byte i of the packed words) at k pair
// (2p, 2p + 1): the high nibble is the even k, the lower half
__device__ __forceinline__ uint32_t deq_pair(uint32_t hi, uint32_t lo, int i,
                                             float zero, float scale) {
  return qmm::pack2(deq_code(hi, i, zero, scale), deq_code(lo, i, zero, scale));
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

}  // namespace thin

// grid (splits, N / kBN, M / (8 MT)), cluster (splits, 1, 1). kFast: the
// TMA path with staged scales (K % 8 and N % 16 zero, gs = 2^lg_gs >= 16);
// otherwise the producer warp fills the same layout with plain loads and
// the consumers read scales and zeros through the read-only cache.
template <int MT, bool kFast>
__global__ void __launch_bounds__(thin::kThreads, thin::Geo<MT>::kMinBlocks)
int4_thin_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_p,
                 const __grid_constant__ CUtensorMap tm_s,
                 const __grid_constant__ CUtensorMap tm_z,
                 const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                 const float* __restrict__ scales,
                 const float* __restrict__ zeros, void* __restrict__ out,
                 int M, int K, int N, int gs, int lg_gs, int n_groups,
                 int out_dtype) {
  using Gm = thin::Geo<MT>;
  constexpr int kBN = thin::kBN;
  constexpr int kKC = thin::kKC;
  constexpr int kS = Gm::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[thin::kMaxStages];
  __shared__ __align__(8) uint64_t empty[thin::kMaxStages];
  // the 128-byte swizzle repeats every 1024 bytes: stages start there
  uint8_t* smem =
      smem_raw + ((1024 - (qmm::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int splits = gridDim.x;
  const int split = blockIdx.x;  // the block's rank in its cluster
  const int n0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * Gm::kRows;
  const int n_chunks = (K + kKC - 1) / kKC;
  const int c_begin = static_cast<int>(static_cast<long>(split) * n_chunks /
                                       splits);
  const int n_local =
      static_cast<int>(static_cast<long>(split + 1) * n_chunks / splits) -
      c_begin;
  const int g_rows = kFast ? thin::staged_group_rows(gs, n_groups) : 0;
  const int st_bytes = thin::stage_bytes<MT>(g_rows);

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      qmm::mbar_init(&full[s], kFast ? 1 : 32);
      qmm::mbar_init(&empty[s], thin::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[2][MT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.0f;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cg = warp & 3;   // column group: 32 columns
  const int kh = warp >> 2;  // k half: k-steps 4 kh .. 4 kh + 3 of a stage
  const int cl = 32 * cg + 4 * g;  // this thread's first column in the slab

  if (warp == thin::kConsumers / 32) {  // producer
    for (int i = 0; i < n_local; ++i) {
      const int s = i % kS;
      if (i >= kS) qmm::mbar_wait(&empty[s], ((i / kS) - 1) & 1);
      uint8_t* st = smem + s * st_bytes;
      const int k0 = (c_begin + i) * kKC;
      if (kFast) {
        if (lane == 0) {
          const uint32_t aux = g_rows * kBN * 4;
          qmm::mbar_expect_tx(&full[s],
                              thin::kCodeBytes + Gm::kXBytes + 2 * aux);
          qmm::tma_load_2d(st, &tm_p, &full[s], n0, k0 / 2);
          uint8_t* sx = st + thin::kCodeBytes;
          qmm::tma_load_2d(sx, &tm_x, &full[s], k0, m0);
          qmm::tma_load_2d(sx + Gm::kRows * 128, &tm_x, &full[s], k0 + 64,
                           m0);
          uint8_t* sa = sx + Gm::kXBytes;
          qmm::tma_load_2d(sa, &tm_s, &full[s], n0, k0 >> lg_gs);
          qmm::tma_load_2d(sa + aux, &tm_z, &full[s], n0, k0 >> lg_gs);
        }
      } else {
        // codes: byte (r, c) at r * 128 + 16 ((c / 16) ^ (r % 8)) + c % 16,
        // as TMA's 128-byte swizzle writes it; zeros past the edges
        for (int e = lane; e < thin::kCodeBytes; e += 32) {
          const int r = e / kBN;
          const int c = e % kBN;
          const int row = k0 / 2 + r;
          st[qmm::sw128(r, c)] =
              (row < K / 2 && n0 + c < N)
                  ? packed[static_cast<long>(row) * N + n0 + c]
                  : 0;
        }
        // x: two boxes of kRows rows x 64 k, the same swizzle
        bf16* sx = reinterpret_cast<bf16*>(st + thin::kCodeBytes);
        for (int e = lane; e < Gm::kRows * kKC; e += 32) {
          const int r = e / kKC;
          const int kk = e % kKC;
          const int box = kk / 64;
          const int row = m0 + r;
          const int k = k0 + kk;
          sx[(box * Gm::kRows * 128 + qmm::sw128(r, 2 * (kk % 64))) / 2] =
              (row < M && k < K) ? x[static_cast<long>(row) * K + k]
                                 : __float2bfloat16_rn(0.0f);
        }
        qmm::mbar_arrive(&full[s]);  // release: the stores above
      }
    }
  } else {  // consumers
    // !kFast: the scales and zeros of the groups of the k-step's two halves
    // (k + 2t and k + 2t + 8) through the read-only cache; groups past the
    // last (k past K: zero x) take the last
    auto load_group = [&](int grp, float4& sc, float4& zr) {
      grp = min(grp, n_groups - 1);
      float v[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = n0 + cl + i;
        const long j = static_cast<long>(grp) * N + c;
        v[0][i] = c < N ? __ldg(scales + j) : 0.0f;
        v[1][i] = c < N ? __ldg(zeros + j) : 0.0f;
      }
      sc = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
      zr = make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
    };
    int cur0 = -1, cur1 = -1;
    float4 s0, z0, s1, z1;
    // byte offsets, in a stage, of this thread's code words in packed rows
    // t and t + 4 (mod 8) and of its x words in row g (mod 8), k 2t and
    // 2t + 8 of each 16, under the 128-byte swizzle
    const int code0 = qmm::sw128(t, cl);
    const int code1 = qmm::sw128(t + 4, cl);
    int xoff[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xoff[q][h] = qmm::sw128(g, 32 * q + 16 * h + 4 * t);
    for (int i = 0; i < n_local; ++i) {
      const int s = i % kS;
      qmm::mbar_wait(&full[s], (i / kS) & 1);
      const uint8_t* sp = smem + s * st_bytes;
      const uint8_t* sx = sp + thin::kCodeBytes + kh * Gm::kRows * 128;
      const float* sa =
          reinterpret_cast<const float*>(sp + thin::kCodeBytes + Gm::kXBytes);
      const int k0 = (c_begin + i) * kKC;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = k0 + 16 * (4 * kh + q);
        if (kFast) {
          // the staged group row; a k past K (zero x) takes the last
          const int r = min(kk >> lg_gs, n_groups - 1) - (k0 >> lg_gs);
          s0 = *reinterpret_cast<const float4*>(sa + r * kBN + cl);
          z0 = *reinterpret_cast<const float4*>(sa + (g_rows + r) * kBN +
                                                cl);
          s1 = s0;
          z1 = z0;
        } else {
          const int ga = (kk + 2 * t) / gs;
          const int gb = (kk + 2 * t + 8) / gs;
          if (ga != cur0) {
            load_group(ga, s0, z0);
            cur0 = ga;
          }
          if (gb != cur1) {
            load_group(gb, s1, z1);
            cur1 = gb;
          }
        }
        // packed rows 8 ks + t (k pair 2t) and + 4 (k pair 2t + 8), bytes
        // 4g .. 4g + 3 of the warp's 32 columns
        const uint8_t* rows = sp + 8 * (4 * kh + q) * 128;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + code0);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + code1);
        const uint32_t lo0 = w0 & 0x0F0F0F0Fu, hi0 = (w0 >> 4) & 0x0F0F0F0Fu;
        const uint32_t lo1 = w1 & 0x0F0F0F0Fu, hi1 = (w1 >> 4) & 0x0F0F0F0Fu;
        uint32_t a[2][4];
#pragma unroll
        for (int ta = 0; ta < 2; ++ta) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * ta + e;
            a[ta][e] = thin::deq_pair(hi0, lo0, c, thin::at(z0, c),
                                      thin::at(s0, c));
            a[ta][2 + e] = thin::deq_pair(hi1, lo1, c, thin::at(z1, c),
                                          thin::at(s1, c));
          }
        }
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          // x row 8j + g at k 16 (ks % 4) + 2t (+ 8) of this half's box
          const uint8_t* xr = sx + 8 * j * 128;
          const uint32_t bx0 =
              *reinterpret_cast<const uint32_t*>(xr + xoff[q][0]);
          const uint32_t bx1 =
              *reinterpret_cast<const uint32_t*>(xr + xoff[q][1]);
          mma_bf16(acc[0][j], a[0], bx0, bx1);
          mma_bf16(acc[1][j], a[1], bx0, bx1);
        }
      }
      // the stage was read by generic loads and its next fill is a TMA
      // (async proxy) write: order the two before handing it back
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      qmm::mbar_arrive(&empty[s]);
    }
    // every consumer is done with the ring: the k-half-1 warps leave their
    // sums there for their k-half-0 partners (the same columns and rows)
    asm volatile("bar.sync 1, %0;\n" ::"n"(thin::kConsumers) : "memory");
    float* xch = reinterpret_cast<float*>(smem) + (tid & 127) * (8 * MT);
    if (kh == 1) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xch[(a * MT + j) * 4 + e] = acc[a][j][e];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(thin::kConsumers) : "memory");
    if (kh == 0) {
      // this thread's quad (columns cl .. cl + 3: tile a, fragment column
      // e / 2) in rows 8j + 2t + p, half 0 + half 1, pushed to the block
      // that owns the quad, into its slot for this split
      const int qd = cl / 4;
      int owner = 0;
      while (owner + 1 < splits && thin::quad_lo(owner + 1, splits) <= qd)
        ++owner;
      const int lo = thin::quad_lo(owner, splits);
      const int n_qd = thin::quad_lo(owner + 1, splits) - lo;
      float* recv = reinterpret_cast<float*>(
          smem + Gm::kStages * st_bytes);
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // column cl + i: tile i / 2
            const int e = 2 * (i % 2) + p;
            v[i] = acc[i / 2][j][e] + xch[((i / 2) * MT + j) * 4 + e];
          }
          const int r = 8 * j + 2 * t + p;
          thin::st_dsmem4(recv + ((r * n_qd + qd - lo) * splits + split) * 4,
                          owner, make_float4(v[0], v[1], v[2], v[3]));
        }
    }
  }
  thin::cluster_sync();  // every split's sums are in their owners' buffers

  // this block's share of the slab: column quads qd_lo .. qd_lo + n_qd - 1
  // of every row, summed over the splits in split order (deterministic)
  const float4* recv =
      reinterpret_cast<const float4*>(smem + Gm::kStages * st_bytes);
  const int qd_lo = thin::quad_lo(split, splits);
  const int n_qd = thin::quad_lo(split + 1, splits) - qd_lo;
  for (int lq = tid; lq < Gm::kRows * n_qd; lq += thin::kThreads) {
    const int r = lq / n_qd;
    const int c = 4 * (qd_lo + lq % n_qd);
    const int m = m0 + r;
    float4 sum = recv[lq * splits];
    for (int q = 1; q < splits; ++q) {
      const float4 p = recv[lq * splits + q];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    if (m < M) {
      const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + c + e < N)
          port::store_out(out, static_cast<long>(m) * N + n0 + c + e, s4[e],
                          out_dtype);
      }
    }
  }
}

template <int MT, bool kFast>
cudaError_t launch_thin(const void* x, const void* packed, const void* scales,
                        const void* zeros, void* out, int M, int K, int N,
                        int gs, int n_groups, int out_dtype,
                        cudaStream_t stream) {
  using Gm = thin::Geo<MT>;
  const auto kernel = int4_thin_kernel<MT, kFast>;
  const int g_rows = kFast ? thin::staged_group_rows(gs, n_groups) : 0;
  const int smem = thin::smem_bytes<MT>(g_rows);
  constexpr int kMaxSmem = 232448 - 256;  // less the static barriers
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap tm_x = {}, tm_p = {}, tm_s = {}, tm_z = {};
  if (kFast) {
    cudaError_t err = qmm::encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     2, x, M, K, Gm::kRows, 64,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = qmm::encode_2d(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed,
                           K / 2, N, thin::kKC / 2, thin::kBN,
                           CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = qmm::encode_2d(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales,
                           n_groups, N, g_rows, thin::kBN,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
      err = qmm::encode_2d(&tm_z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zeros,
                           n_groups, N, g_rows, thin::kBN,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  // splits of K per slab (the cluster size), among those for which every
  // cluster of the grid is resident at once (the occupancy API's count of
  // active clusters at this size and shared memory, queried once per
  // staged row count) and each split has at least two stages: the one that
  // puts the least work on the busiest SM, ceil(blocks / SMs) blocks of
  // 1 / splits of a slab's run each, over the SMs that clusters of that
  // size can use (active clusters x size / blocks per SM); the larger on a
  // tie
  static int per_sm[thin::kKC + 1];                        // [g_rows]
  static int active[thin::kKC + 1][thin::kMaxSplits + 1];  // [g_rows][size]
  if (per_sm[g_rows] == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[g_rows], kernel, thin::kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm[g_rows] < 1) return cudaErrorInvalidConfiguration;
  }
  const int slabs = (N + thin::kBN - 1) / thin::kBN;
  const int m_tiles = (M + Gm::kRows - 1) / Gm::kRows;
  const int n_chunks = (K + thin::kKC - 1) / thin::kKC;
  const long clusters = static_cast<long>(slabs) * m_tiles;
  int splits = 1;
  long best_num = -1;  // the busiest SM's work: best_num / splits runs
  for (int c = 1; c <= thin::kMaxSplits && (c == 1 || n_chunks >= 2 * c);
       ++c) {
    int& n_active = active[g_rows][c];
    if (n_active == 0) {
      cudaLaunchConfig_t q = {};
      q.gridDim = dim3(c, 1, 1);
      q.blockDim = dim3(thin::kThreads);
      q.dynamicSmemBytes = smem;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = c;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      q.attrs = at;
      q.numAttrs = 1;
      const cudaError_t err =
          cudaOccupancyMaxActiveClusters(&n_active, kernel, &q);
      if (err != cudaSuccess) return err;
      if (n_active == 0) n_active = -1;  // not resident at this size
    }
    if (n_active < 1 || clusters > n_active) continue;
    long sms = static_cast<long>(n_active) * c / per_sm[g_rows];
    if (sms < 1) sms = 1;
    const long num = (clusters * c + sms - 1) / sms;
    if (best_num < 0 || num * splits <= best_num * c) {
      splits = c;
      best_num = num;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, slabs, m_tiles);
  cfg.blockDim = dim3(thin::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_p, tm_s, tm_z,
                            static_cast<const bf16*>(x),
                            static_cast<const uint8_t*>(packed),
                            static_cast<const float*>(scales),
                            static_cast<const float*>(zeros), out, M, K, N,
                            gs, 31 - __builtin_clz(gs), n_groups, out_dtype);
}

template <int MT>
cudaError_t launch_thin_mt(const void* x, const void* packed,
                           const void* scales, const void* zeros, void* out,
                           int M, int K, int N, int gs, int n_groups,
                           int out_dtype, cudaStream_t stream) {
  return (K % 8 == 0 && N % 16 == 0 && gs >= 16 && (gs & (gs - 1)) == 0)
             ? launch_thin<MT, true>(x, packed, scales, zeros, out, M, K, N,
                                     gs, n_groups, out_dtype, stream)
             : launch_thin<MT, false>(x, packed, scales, zeros, out, M, K, N,
                                      gs, n_groups, out_dtype, stream);
}
}  // namespace

// Forward on the wgmma mainloop (Int4Fwd), on `stream`: the route for
// prefill and training row counts. x: (M, K) bf16, 16-byte aligned; packed:
// (K/2, N) uint8; scales, zeros: (n_groups, N) f32, all 16-byte aligned;
// out: (M, N) in out_dtype (0 f32, 1 bf16, 2 f16). Requires M >= 1, K % 8
// == 0 and N % 16 == 0 (the TMA row
// strides, 2K, N and 4N bytes, must be 16-byte multiples), gs even with
// gs % 64 == 0 or 64 % gs == 0. Returns the first CUDA error of the
// descriptor encoding and the launch (0 on success).
extern "C" int int4_matmul_wgmma_launch(const void* x, const void* packed,
                                        const void* scales, const void* zeros,
                                        void* out, int M, int K, int N, int gs,
                                        int n_groups, int out_dtype,
                                        void* stream) {
  if (M < 1 || K % 8 || N % 16 || gs < 2 || gs % 2 ||
      (gs % qmm::kChunk && qmm::kChunk % gs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // group rows that cover any 64 k starting at a multiple of 64
  int g_rows = gs >= qmm::kChunk ? 1 : qmm::kChunk / gs;
  if (g_rows > n_groups) g_rows = n_groups;
  CUtensorMap tm_x, tm_p, tm_s, tm_z;
  cudaError_t err = qmm::encode_act(&tm_x, x, M, K);
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed,
                         K / 2, N, qmm::kChunk / 2, qmm::kTileCols,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales,
                         n_groups, N, g_rows, qmm::kTileCols,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zeros,
                         n_groups, N, g_rows, qmm::kTileCols,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int aux = (2 * g_rows * qmm::kTileCols * 4 + 1023) / 1024 * 1024;
  const qmm::QmmArgs args = {out, M, N, K, out_dtype, gs, g_rows, aux,
                             nullptr};
  return static_cast<int>(qmm::launch_qmm<Int4Fwd>(
      tm_x, tm_p, tm_s, tm_z, args, static_cast<cudaStream_t>(stream)));
}

// Backward, on `stream`. dy: (M, N) bf16, 16-byte aligned; packed, scales,
// zeros as for the forward, 16-byte aligned; dx: (M, K) in out_dtype.
// Requires M >= 1, K even, gs even, N % 16 == 0 (the TMA row strides, N,
// 2N and 4N bytes, must be 16-byte multiples). Returns the first CUDA error
// of the descriptor encoding and the launch (0 on success).
extern "C" int int4_matmul_bwd_launch(const void* dy, const void* packed,
                                      const void* scales, const void* zeros,
                                      void* dx, int M, int K, int N, int gs,
                                      int n_groups, int out_dtype,
                                      void* stream) {
  // group rows that cover any 128 dx columns starting at a multiple of 128
  int g_rows = gs % qmm::kTileCols == 0   ? 1
               : qmm::kTileCols % gs == 0 ? qmm::kTileCols / gs
                                          : (qmm::kTileCols - 1) / gs + 2;
  if (g_rows > n_groups) g_rows = n_groups;
  CUtensorMap tm_dy, tm_p, tm_s, tm_z;
  cudaError_t err = qmm::encode_act(&tm_dy, dy, M, N);
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed,
                         K / 2, N, qmm::kTileCols / 2, qmm::kChunk,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales,
                         n_groups, N, g_rows, qmm::kChunk,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zeros,
                         n_groups, N, g_rows, qmm::kChunk,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int aux = (2 * g_rows * qmm::kChunk * 4 + 1023) / 1024 * 1024;
  const qmm::QmmArgs args = {dx, M, K, N, out_dtype, gs, g_rows, aux,
                             nullptr};
  return static_cast<int>(qmm::launch_qmm<Int4Dx>(
      tm_dy, tm_p, tm_s, tm_z, args, static_cast<cudaStream_t>(stream)));
}

// Forward on the thin-M kernel (int4_thin_kernel), on `stream`: the route
// for decode row counts. x: (M, K) bf16, 16-byte aligned; packed, scales,
// zeros as for int4_matmul_wgmma_launch; out: (M, N) in out_dtype. Requires
// M >= 1, K even and gs even. One launch (a cluster per column slab), no
// workspace. Returns the first CUDA error of the descriptor encoding and
// the launch (0 on success).
extern "C" int int4_matmul_thin_launch(const void* x, const void* packed,
                                       const void* scales, const void* zeros,
                                       void* out, int M, int K, int N, int gs,
                                       int n_groups, int out_dtype,
                                       void* stream) {
  if (M < 1 || K < 2 || K % 2 || N < 1 || gs < 2 || gs % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 8) {
    err = launch_thin_mt<1>(x, packed, scales, zeros, out, M, K, N, gs,
                            n_groups, out_dtype, s);
  } else if (M <= 16) {
    err = launch_thin_mt<2>(x, packed, scales, zeros, out, M, K, N, gs,
                            n_groups, out_dtype, s);
  } else if (M <= 32) {
    err = launch_thin_mt<4>(x, packed, scales, zeros, out, M, K, N, gs,
                            n_groups, out_dtype, s);
  } else if (M <= 64) {
    err = launch_thin_mt<8>(x, packed, scales, zeros, out, M, K, N, gs,
                            n_groups, out_dtype, s);
  } else {
    err = launch_thin_mt<16>(x, packed, scales, zeros, out, M, K, N, gs,
                             n_groups, out_dtype, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
