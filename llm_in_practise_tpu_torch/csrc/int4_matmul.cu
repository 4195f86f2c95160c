// W4A16 int4 dequant-matmul for Hopper (sm_90a), forward and backward:
//   y  = x  @ W     (qmm_wgmma_kernel<Int4Fwd> at prefill and training row
//                    counts; qmm_thin_kernel<Int4Thin> of qmm_thin.cuh at
//                    decode row counts)
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
//     to fill 132 SMs: the thin-M streaming kernel of qmm_thin.cuh with the
//     Int4Thin policy (below), shared with the NF4 and int8 forwards,
//     streams long runs of packed rows through a warp-specialized TMA ring,
//     decodes on mma.sync with the weight as the A operand (8 rows of x fill
//     an n8 tile), and sums the K splits of a column slab inside a
//     thread-block cluster through distributed shared memory: one launch,
//     no workspace, deterministic. The wrapper picks the route by shape
//     (ops/int4_matmul.py::_route).
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

#include "mma_util.cuh"
#include "qmm_thin.cuh"
#include "qmm_wgmma.cuh"

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

// B6's policy for the thin-M kernel of qmm_thin.cuh (decode row counts). A
// stage holds 64 packed rows x 128 bytes of codes (k0 .. k0 + 127 of local
// columns n0 .. n0 + 127, the 128-byte swizzle) and, on the TMA path (K % 8
// and N % 16 zero, gs a power of two from 16 up), the group rows of scales
// and zeros that cover the stage; the plain path fills the same code layout
// and the consumers read scales and zeros through the read-only cache.
// Thread (g, t) owns local columns cl .. cl + 3: one 32-bit load of packed
// row kp gives a[0] and a[1] of both tiles and packed row kp + 4 gives a[2]
// and a[3]; the scales and zeros of the 4 columns are one 16-byte load each.
// Each weight is (code - zero) * scale in f32 with each step rounded on its
// own, as the codec does, and one rounding to bf16 per pair. A word's 8
// nibbles become 8 exact floats 2^23 + code with two masks, a shift and one
// byte permute each.
struct Int4Thin {
  static constexpr int kWBytes = (thin::kKC / 2) * thin::kBN;
  static constexpr uint32_t kMagic = 0x4B000000u;  // 2^23 as f32 bits

  __host__ __device__ static constexpr int stages(int mt) {
    return mt <= 2 ? 6 : mt <= 4 ? 4 : 3;
  }
  __host__ __device__ static constexpr int min_blocks(int mt) {
    return mt <= 2 ? 3 : mt <= 4 ? 2 : 1;
  }

  // group rows of scales (and as many of zeros) staged per stage on the TMA
  // path (gs a power of two): those that cover kKC k from a multiple of kKC
  static int staged_group_rows(int gs, int n_groups) {
    const int rows = gs >= thin::kKC ? 1 : thin::kKC / gs;
    return rows < n_groups ? rows : n_groups;
  }

  __host__ __device__ static int aux_bytes(const thin::ThinArgs& args) {
    return 2 * args.g_rows * thin::kBN * 4;
  }
  __host__ __device__ static int slabs(int n) {
    return (n + thin::kBN - 1) / thin::kBN;
  }
  __device__ static int out_col(int slab, int lc, const thin::ThinArgs& args) {
    const int col = slab * thin::kBN + lc;
    return col < args.N ? col : -1;
  }
  __device__ static void block_init() {}

  __device__ static uint32_t tx_bytes(const thin::ThinArgs& args) {
    return kWBytes + aux_bytes(args);
  }

  __device__ static void load(uint8_t* w, uint8_t* aux,
                              const CUtensorMap* tm_p, const CUtensorMap* tm_s,
                              const CUtensorMap* tm_z, uint64_t* bar,
                              int slab, int k0, const thin::ThinArgs& args) {
    const int n0 = slab * thin::kBN;
    qmm::tma_load_2d(w, tm_p, bar, n0, k0 / 2);
    qmm::tma_load_2d(aux, tm_s, bar, n0, k0 >> args.lg_gs);
    qmm::tma_load_2d(aux + args.g_rows * thin::kBN * 4, tm_z, bar, n0,
                     k0 >> args.lg_gs);
  }

  // codes: byte (r, c) at r * 128 + 16 ((c / 16) ^ (r % 8)) + c % 16, as
  // TMA's 128-byte swizzle writes it; zeros past the edges
  __device__ static void fill(uint8_t* w, uint8_t*, int lane, int slab,
                              int k0, const thin::ThinArgs& args) {
    const int n0 = slab * thin::kBN;
    for (int e = lane; e < kWBytes; e += 32) {
      const int r = e / thin::kBN;
      const int c = e % thin::kBN;
      const int row = k0 / 2 + r;
      w[qmm::sw128(r, c)] =
          (row < args.K / 2 && n0 + c < args.N)
              ? args.w[static_cast<long>(row) * args.N + n0 + c]
              : 0;
    }
  }

  // (code - zero) * scale for the code in byte `i` of `nib` (0 .. 15 per
  // byte), each step rounded in f32 as the codec does: the bits 2^23 + code
  // are an exact f32, less 2^23 the code itself
  static __device__ __forceinline__ float deq_code(uint32_t nib, int i,
                                                   float zero, float scale) {
    const float m = __uint_as_float(__byte_perm(nib, kMagic, 0x7650 + i));
    return __fmul_rn(__fsub_rn(__fsub_rn(m, 8388608.0f), zero), scale);
  }

  // A register of weight column `i` (byte i of the packed words) at k pair
  // (2p, 2p + 1): the high nibble is the even k, the lower half
  static __device__ __forceinline__ uint32_t deq_pair(uint32_t hi, uint32_t lo,
                                                      int i, float zero,
                                                      float scale) {
    return qmm::pack2(deq_code(hi, i, zero, scale),
                      deq_code(lo, i, zero, scale));
  }

  static __device__ __forceinline__ float at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }

  struct State {
    int cl, n0, t, code0, code1, cur0, cur1;
    float4 s0, z0, s1, z1;

    __device__ State(const thin::ThinArgs&, int slab, int cl_, int, int,
                     int t_)
        : cl(cl_),
          n0(slab * thin::kBN),
          t(t_),
          // byte offsets, in a stage, of this thread's code words in packed
          // rows t and t + 4 (mod 8), under the 128-byte swizzle
          code0(qmm::sw128(t_, cl_)),
          code1(qmm::sw128(t_ + 4, cl_)),
          cur0(-1),
          cur1(-1) {}

    template <bool kFast>
    __device__ void stage(const uint8_t*, int, const thin::ThinArgs&) {}

    // the plain path's scales and zeros of group `grp` for the thread's 4
    // columns, through the read-only cache; groups past the last (k past
    // K: zero x) take the last
    __device__ void load_group(int grp, float4& sc, float4& zr,
                               const thin::ThinArgs& args) const {
      grp = min(grp, args.n_groups - 1);
      const auto* scales = static_cast<const float*>(args.aux0);
      const auto* zeros = static_cast<const float*>(args.aux1);
      float v[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = n0 + cl + i;
        const long j = static_cast<long>(grp) * args.N + c;
        v[0][i] = c < args.N ? __ldg(scales + j) : 0.0f;
        v[1][i] = c < args.N ? __ldg(zeros + j) : 0.0f;
      }
      sc = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
      zr = make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
    }

    template <bool kFast>
    __device__ void decode(const uint8_t* w, const uint8_t* aux, int ks,
                           int k0, const thin::ThinArgs& args,
                           uint32_t (&a)[2][4]) {
      const int kk = k0 + 16 * ks;
      if (kFast) {
        // the staged group row; a k past K (zero x) takes the last
        const auto* sa = reinterpret_cast<const float*>(aux);
        const int r = min(kk >> args.lg_gs, args.n_groups - 1) -
                      (k0 >> args.lg_gs);
        s0 = *reinterpret_cast<const float4*>(sa + r * thin::kBN + cl);
        z0 = *reinterpret_cast<const float4*>(
            sa + (args.g_rows + r) * thin::kBN + cl);
        s1 = s0;
        z1 = z0;
      } else {
        // the groups of the k-step's two halves (k + 2t and k + 2t + 8)
        const int ga = (kk + 2 * t) / args.gs;
        const int gb = (kk + 2 * t + 8) / args.gs;
        if (ga != cur0) {
          load_group(ga, s0, z0, args);
          cur0 = ga;
        }
        if (gb != cur1) {
          load_group(gb, s1, z1, args);
          cur1 = gb;
        }
      }
      // packed rows 8 ks + t (k pair 2t) and + 4 (k pair 2t + 8), bytes
      // 4g .. 4g + 3 of the warp's 32 columns
      const uint8_t* rows = w + 8 * ks * 128;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + code0);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + code1);
      const uint32_t lo0 = w0 & 0x0F0F0F0Fu, hi0 = (w0 >> 4) & 0x0F0F0F0Fu;
      const uint32_t lo1 = w1 & 0x0F0F0F0Fu, hi1 = (w1 >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int ta = 0; ta < 2; ++ta) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * ta + e;
          a[ta][e] = deq_pair(hi0, lo0, c, at(z0, c), at(s0, c));
          a[ta][2 + e] = deq_pair(hi1, lo1, c, at(z1, c), at(s1, c));
        }
      }
    }
  };
};

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

// Forward on the thin-M kernel (qmm_thin_kernel<Int4Thin>), on `stream`:
// the route for decode row counts. x: (M, K) bf16, 16-byte aligned; packed,
// scales, zeros as for int4_matmul_wgmma_launch; out: (M, N) in out_dtype.
// Requires M >= 1, K even and gs even. One launch (a cluster per column
// slab), no workspace. Returns the first CUDA error of the descriptor
// encoding and the launch (0 on success).
extern "C" int int4_matmul_thin_launch(const void* x, const void* packed,
                                       const void* scales, const void* zeros,
                                       void* out, int M, int K, int N, int gs,
                                       int n_groups, int out_dtype,
                                       void* stream) {
  if (M < 1 || K < 2 || K % 2 || N < 1 || gs < 2 || gs % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool fast =
      K % 8 == 0 && N % 16 == 0 && gs >= 16 && (gs & (gs - 1)) == 0;
  thin::ThinArgs args = {};
  args.x = static_cast<const bf16*>(x);
  args.w = static_cast<const uint8_t*>(packed);
  args.aux0 = scales;
  args.aux1 = zeros;
  args.out = out;
  args.M = M;
  args.K = K;
  args.N = N;
  args.out_dtype = out_dtype;
  args.gs = gs;
  args.lg_gs = 31 - __builtin_clz(gs);
  args.n_groups = n_groups;
  args.g_rows = fast ? Int4Thin::staged_group_rows(gs, n_groups) : 0;
  CUtensorMap tm_p = {}, tm_s = {}, tm_z = {};
  if (fast) {
    cudaError_t err = qmm::encode_2d(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                     packed, K / 2, N, thin::kKC / 2,
                                     thin::kBN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = qmm::encode_2d(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales,
                           n_groups, N, args.g_rows, thin::kBN,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
      err = qmm::encode_2d(&tm_z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zeros,
                           n_groups, N, args.g_rows, thin::kBN,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(thin::launch<Int4Thin>(
      tm_p, tm_s, tm_z, args, fast, args.g_rows,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* int4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
