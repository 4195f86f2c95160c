// W4A16 int4 dequant-matmul for Hopper (sm_90a), forward and backward:
//   y  = x  @ W     (qmm_wgmma_kernel<Int4Fwd> at prefill and training row
//                    counts; int4_matmul_kernel, split over K, at decode)
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
//     to fill 132 SMs: int4_matmul_kernel (mma.sync m16n8k16 on 16-row
//     tiles, the byte as one B register) splits K over grid.z (the NF4
//     kernel's split_k_for); each split writes f32 partials and a second
//     kernel sums them in a fixed order (deterministic, no atomics). Each
//     thread looks up the group of its fragment's row pair and reloads scale
//     and zero only when the group changes. The wrapper picks the route by
//     shape (ops/int4_matmul.py::_route).
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
//   - The M, N and K edges are masked (split-K: zero-filled tiles and
//     guarded stores; wgmma: TMA's zero fill and guarded stores).

#include "qmm_wgmma.cuh"
#include "mma_util.cuh"

namespace {

using port::mma_bf16;
using port::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // 4 warps
constexpr int kBK = 64;             // K rows per chunk (32 packed rows)
constexpr int kBN = 64;             // output columns per block, 16 per warp
constexpr int kPStride = kBN + 16;  // smem bytes per packed row (bank spread)
constexpr int kXStride = kBK + 8;   // smem bf16 per x row (bank spread)

// (code - zero) * scale in f32, each step rounded on its own
__device__ __forceinline__ float deq(uint32_t code, float zero, float scale) {
  return __fmul_rn(__fsub_rn(static_cast<float>(code), zero), scale);
}

// One block: rows [m0, m0 + 16*MT) of x against output columns
// [n0, n0 + kBN), over the K chunks of split blockIdx.z. Warp w owns
// columns n0 + 16w .. n0 + 16w + 15 as two n8 tiles.
template <int MT, int STAGES>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const bf16* __restrict__ x,
                   const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales,
                   const float* __restrict__ zeros, void* __restrict__ out,
                   float* __restrict__ ws, int M, int K, int N, int gs,
                   int n_groups, int split_k, int out_dtype) {
  constexpr int BM = 16 * MT;
  __shared__ __align__(16) uint8_t s_p[STAGES][(kBK / 2) * kPStride];
  __shared__ __align__(16) bf16 s_x[STAGES][BM * kXStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread in group
  const int KP = K >> 1;    // packed rows
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int n_chunks = (K + kBK - 1) / kBK;
  const int kc_begin =
      static_cast<int>(static_cast<long>(blockIdx.z) * n_chunks / split_k);
  const int kc_end =
      static_cast<int>(static_cast<long>(blockIdx.z + 1) * n_chunks / split_k);
  const int n_local = kc_end - kc_begin;
  const bool p_vec = (N % 16) == 0;  // 16-byte aligned packed rows
  const bool x_vec = (K % 8) == 0;   // 16-byte aligned x rows

  auto load_stage = [&](int stage, int kc) {
    const int k0 = kc * kBK;
    const int kp0 = k0 >> 1;
    // packed tile: 32 rows x kBN bytes; zeros past the K and N edges
    for (int i = tid; i < (kBK / 2) * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16);
      const int part = i % (kBN / 16);
      const int row = kp0 + r;
      const int col = n0 + part * 16;
      uint8_t* dst = &s_p[stage][r * kPStride + part * 16];
      if (p_vec) {
        const bool ok = row < KP && col < N;
        port::cp_async16(dst, packed + (ok ? static_cast<long>(row) * N + col
                                            : 0),
                         ok ? 16 : 0);
      } else {
        for (int b = 0; b < 16; ++b) {
          dst[b] = (row < KP && col + b < N)
                       ? packed[static_cast<long>(row) * N + col + b]
                       : 0;
        }
      }
    }
    // x tile: BM rows x kBK bf16; zeros past the M and K edges
    for (int i = tid; i < BM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int part = i % (kBK / 8);
      const int row = m0 + r;
      const int col = k0 + part * 8;
      bf16* dst = &s_x[stage][r * kXStride + part * 8];
      if (x_vec) {
        const bool ok = row < M && col < K;
        port::cp_async16(dst, x + (ok ? static_cast<long>(row) * K + col : 0),
                         ok ? 16 : 0);
      } else {
        for (int e = 0; e < 8; ++e) {
          dst[e] = (row < M && col + e < K)
                       ? x[static_cast<long>(row) * K + col + e]
                       : __float2bfloat16_rn(0.0f);
        }
      }
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][h][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_local) load_stage(s, kc_begin + s);
    port::cp_async_commit();
  }

  // this thread's B columns (one per n8 tile) and their group parameters
  const int col0 = n0 + warp * 16 + g;
  auto load_group = [&](int grp, float (&sc)[2], float (&zr)[2]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = col0 + nt * 8;
      const long j = static_cast<long>(grp) * N + c;
      sc[nt] = c < N ? __ldg(scales + j) : 0.0f;
      zr[nt] = c < N ? __ldg(zeros + j) : 0.0f;
    }
  };
  int cur_a = -1, cur_b = -1;  // groups of the b0 and b1 row pairs
  float sa[2], za[2], sb[2], zb[2];

  for (int i = 0; i < n_local; ++i) {
    port::cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nxt = i + STAGES - 1;
      if (nxt < n_local) load_stage(nxt % STAGES, kc_begin + nxt);
      port::cp_async_commit();
    }
    const int stage = i % STAGES;
    const int k0 = (kc_begin + i) * kBK;
    const uint8_t* sp = s_p[stage] + warp * 16 + g;
    const bf16* sx = s_x[stage];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // K rows k0 + 16ks + 2t (+1) feed b0, the same + 8 feed b1; rows past
      // K (zero x) take the last group
      const int kr = k0 + ks * 16 + 2 * t;
      const int ga = min(kr / gs, n_groups - 1);
      const int gb = min((kr + 8) / gs, n_groups - 1);
      if (ga != cur_a) {
        load_group(ga, sa, za);
        cur_a = ga;
      }
      if (gb != cur_b) {
        if (gb == cur_a) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            sb[nt] = sa[nt];
            zb[nt] = za[nt];
          }
        } else {
          load_group(gb, sb, zb);
        }
        cur_b = gb;
      }
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t p0 = sp[(ks * 8 + t) * kPStride + nt * 8];
        const uint32_t p1 = sp[(ks * 8 + t + 4) * kPStride + nt * 8];
        b[nt][0] = pack_bf16(deq(p0 >> 4, za[nt], sa[nt]),
                             deq(p0 & 15, za[nt], sa[nt]));
        b[nt][1] = pack_bf16(deq(p1 >> 4, zb[nt], sb[nt]),
                             deq(p1 & 15, zb[nt], sb[nt]));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* xa = sx + (mt * 16 + g) * kXStride + ks * 16 + 2 * t;
        uint32_t a[4];
        a[0] = port::ld_u32(xa);
        a[1] = port::ld_u32(xa + 8 * kXStride);
        a[2] = port::ld_u32(xa + 8);
        a[3] = port::ld_u32(xa + 8 * kXStride + 8);
        mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
        mma_bf16(acc[mt][1], a, b[1][0], b[1][1]);
      }
    }
  }
  port::cp_async_wait<0>();

  const long mn = static_cast<long>(M) * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + warp * 16 + nt * 8 + 2 * t + (e & 1);
        if (row < M && col < N) {
          const long o = static_cast<long>(row) * N + col;
          if (split_k > 1) {
            ws[blockIdx.z * mn + o] = acc[mt][nt][e];
          } else {
            port::store_out(out, o, acc[mt][nt][e], out_dtype);
          }
        }
      }
    }
  }
}

// Sum the split-K partials in split order and write the output dtype.
__global__ void int4_splitk_reduce_kernel(const float* __restrict__ ws,
                                          void* __restrict__ out, long mn,
                                          int split_k, int out_dtype) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < split_k; ++z) s += ws[z * mn + i];
  port::store_out(out, i, s, out_dtype);
}

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
// to the split-K kernel.
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
}  // namespace

// Forward, on `stream`. x: (M, K) bf16, 16-byte aligned; packed: (K/2, N)
// uint8; scales, zeros: (n_groups, N) f32; out: (M, N) in out_dtype (0 f32,
// 1 bf16, 2 f16); ws: (split_k, M, N) f32 when split_k > 1. Requires
// M >= 1, K even, gs even. Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int int4_matmul_launch(const void* x, const void* packed,
                                  const void* scales, const void* zeros,
                                  void* out, void* ws, int M, int K, int N,
                                  int gs, int n_groups, int split_k,
                                  int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* pb = static_cast<const uint8_t*>(packed);
  const auto* sc = static_cast<const float*>(scales);
  const auto* zr = static_cast<const float*>(zeros);
  auto* wsf = static_cast<float*>(ws);
  if (M <= 16) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16, split_k);
    int4_matmul_kernel<1, 4><<<grid, block, 0, s>>>(
        xb, pb, sc, zr, out, wsf, M, K, N, gs, n_groups, split_k, out_dtype);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64, split_k);
    int4_matmul_kernel<4, 3><<<grid, block, 0, s>>>(
        xb, pb, sc, zr, out, wsf, M, K, N, gs, n_groups, split_k, out_dtype);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split_k == 1) return static_cast<int>(err);
  const long mn = static_cast<long>(M) * N;
  int4_splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                              s>>>(wsf, out, mn, split_k, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// Forward on the wgmma mainloop (Int4Fwd), on `stream`: the route for
// prefill and training row counts. x: (M, K) bf16, 16-byte aligned; packed,
// scales, zeros as for int4_matmul_launch, 16-byte aligned; out: (M, N) in
// out_dtype. Requires M >= 1, K % 8 == 0 and N % 16 == 0 (the TMA row
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
extern "C" const char* int4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
