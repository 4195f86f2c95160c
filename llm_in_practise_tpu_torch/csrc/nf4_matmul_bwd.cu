// NF4 dequant-matmul backward for Hopper (sm_90a): dx = dy @ dequant_nf4(W)^T
// (qmm_wgmma_kernel<Nf4Dx>).
//
// Replaces the TPU kernel llm_in_practise_tpu/ops/nf4_matmul.py::_bwd_kernel
// (launched by _call_bwd through pl.pallas_call). The QLoRA base is frozen,
// so only dx exists: there is no dW. It reads the same bytes as the forward
// kernel (csrc/nf4_matmul.cu): W is an NF4Tensor in "kblock" layout, packed
// (K, N/2) uint8 where byte [k, i] holds code[k, i] (high nibble) and
// code[k, N/2 + i] (low nibble); absmax blocks of 64 rows run along K and are
// double-quantized (absmax_q uint8 (K/64, N), absmax_scale f32 per 256 flat
// absmax values, absmax_offset f32).
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16): at training
// row counts (M = 8192) the 2*M*K*N tensor-core operations bound it by far
// (the packed weight is ~4.13 bits per parameter and dy/dx are read and
// written once): 3.196 ms for one Qwen3-8B layer's 7 projections.
//
// What the design does about that bound:
//   - The shared wgmma mainloop of qmm_wgmma.cuh, as dx^T = W . dy^T: TMA
//     ring, one producer thread, two consumer warpgroups on a 128 (dx
//     columns k) x 256 (dx rows) tile, all of N reduced inside the block
//     (deterministic, no atomics). A row of packed bytes is contiguous along
//     the reduction n, so W is a K-major A operand, decoded from the staged
//     bytes straight into register A fragments; the bf16 weight never exists
//     in device or shared memory. The mma.sync design it replaced (64 x 64
//     dx tile, 4 warps, a 3-stage cp.async ring of 32-byte packed chunks)
//     took 20.85 ms for one layer's 7 projections at M = 8192, 5.3x cuBLAS
//     on a dequantized weight (NVIDIA H100 80GB HBM3, 700 W).
//   - The split-half pairing: one packed byte column c feeds reduction
//     index c (high nibble, against dy column c) and N/2 + c (low nibble,
//     against dy column N/2 + c). The policy walks the halves one after the
//     other: ceil(N/128) stages of high nibbles against dy columns c0, then
//     the same packed boxes again with the low nibbles against dy columns
//     N/2 + c0. Where N/2 % 64 == 32, the last high-half stage's packed box
//     runs past N/2 (zero fill, whose code 0 decodes to -absmax, not 0) and
//     its dy box into the low half: that stage's last 32 columns are
//     decoded as zero weights. The low half's last box runs past N, where
//     TMA's zero fill of dy masks it.
//   - The double-quantized absmax is staged in the ring: a 128-row tile
//     spans two absmax rows, one per consumer warpgroup, so each thread's
//     absmax row is fixed and only its column varies with the stage. A
//     64-column run of absmax starts at a multiple of 32 of the flat
//     index, so it meets at most one boundary of the 256-value scale blocks,
//     at its 32nd column: the stage holds 8 scales from a 16-byte-aligned
//     index at or below the run's first scale block, and columns 0-31 and
//     32-63 each take one.
//   - The decode arithmetic is the forward kernels' own (nf4_codec.cuh:
//     __fmul_rn, __fadd_rn, then one rounding to bf16), so the kernel
//     differs from its plain version only in summation order; the codebook
//     sits in shared memory.

#include "nf4_codec.cuh"
#include "qmm_wgmma.cuh"

namespace {

// B2's decode policy. A stage: the weight tile, 128 packed rows x 64 bytes
// (TMA, 64-byte swizzle, so the 16-bit fragment loads of 8 rows fall in 8
// different bank pairs); then the aux bytes: absmax_q rows kb0 and kb0 + 1
// (kb0 = k0 / 64) x the stage's 64 columns at offset 0, and 8 absmax scales
// of each row's run at kScaleOff + 128 r, from the 16-byte-aligned index at
// or below the run's first scale block (TMA faults with an illegal
// instruction on a box whose innermost start is not 16-byte aligned). Fragment row r of warp w in
// warpgroup wg is dx column k0 + 64 wg + 16 w + r, in absmax row kb0 + wg.
struct Nf4Dx : qmm::LinearCols {
  static constexpr uint32_t kWBytes = qmm::kTileCols * qmm::kChunk;
  static constexpr int kScaleOff = 128;  // bytes into the aux area

  // stages per half of N (the reduction)
  __device__ static int half_chunks(const qmm::QmmArgs& args) {
    return (args.red / 2 + qmm::kChunk - 1) / qmm::kChunk;
  }

  // packed column of stage i's box (both halves read the same boxes)
  __device__ static int packed_col(int i, const qmm::QmmArgs& args) {
    const int hc = half_chunks(args);
    return (i < hc ? i : i - hc) * qmm::kChunk;
  }

  __device__ static uint32_t tx_bytes(const qmm::QmmArgs&) {
    return kWBytes + 2 * qmm::kChunk + 2 * 32;
  }

  __device__ static int n_chunks(const qmm::QmmArgs& args) {
    return 2 * half_chunks(args);
  }

  __device__ static int act_col(int i, const qmm::QmmArgs& args) {
    return (i < half_chunks(args) ? 0 : args.red / 2) + packed_col(i, args);
  }

  __device__ static void load(uint8_t* w, const CUtensorMap* tm_packed,
                              const CUtensorMap* tm_aq,
                              const CUtensorMap* tm_ascale, uint64_t* bar,
                              int i, int k0, const qmm::QmmArgs& args) {
    const int col = act_col(i, args);
    const int kb0 = k0 / 64;
    uint8_t* aux = w + kWBytes;
    qmm::tma_load_2d(w, tm_packed, bar, packed_col(i, args), k0);
    qmm::tma_load_2d(aux, tm_aq, bar, col, kb0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int flat = (kb0 + r) * args.red + col;
      qmm::tma_load_1d(aux + kScaleOff + 128 * r, tm_ascale, bar,
                       (flat >> 8) & ~3);
    }
  }

  __device__ static int col_local(int wg, int warp, int g, int hi) {
    return 64 * wg + 16 * warp + g + 8 * hi;
  }

  struct State {
    int row, t, wg, flat_row, nh, hc;
    float offset;
    __device__ State(const qmm::QmmArgs& args, int k0, int wg_, int warp,
                     int g, int t_)
        : row(64 * wg_ + 16 * warp + g),
          t(t_),
          wg(wg_),
          flat_row((k0 / 64 + wg_) * args.red),
          nh(args.red / 2),
          hc(half_chunks(args)),
          offset(*args.param) {
      nf4::fill_codebook();
      qmm::consumer_sync();
    }

    // bytes (c, c + 1) of packed rows `row` and `row + 8`, and of the same
    // + 8 columns, are the fragment pairs; the stage's half picks the nibble
    __device__ void decode(const uint8_t* w, const float* auxf, int i, int ks,
                           uint32_t (&a)[4]) const {
      const bool low = i >= hc;
      const int pc = (low ? i - hc : i) * qmm::kChunk;
      // past N/2 in the last high-half stage: zero weights (a mask, not a
      // branch, so nothing but wgmma writes the accumulators in the loop)
      const uint32_t live = low || 16 * ks < nh - pc ? 0xFFFFFFFFu : 0u;
      const auto* aux = reinterpret_cast<const uint8_t*>(auxf);
      // the run's scale: columns 0-31 and 32-63 may lie in two blocks
      const int flat = flat_row + (low ? nh : 0) + pc;
      const float scale = reinterpret_cast<const float*>(
          aux + kScaleOff + 128 * wg)[((flat + (ks >= 2 ? 32 : 0)) >> 8) -
                                      ((flat >> 8) & ~3)];
      const int c = 16 * ks + 2 * t;
      const auto ld = [](const uint8_t* p) {
        return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
      };
      const uint32_t q0 = ld(aux + 64 * wg + c);
      const uint32_t q8 = ld(aux + 64 * wg + c + 8);
      const float am[4] = {nf4::absmax(q0 & 255, scale, offset),
                           nf4::absmax(q0 >> 8, scale, offset),
                           nf4::absmax(q8 & 255, scale, offset),
                           nf4::absmax(q8 >> 8, scale, offset)};
      const int sh = low ? 0 : 4;
      const auto pair = [&](uint32_t p, int j) {  // bytes c, c + 1 of a row
        return qmm::pack2(nf4::weight((p >> sh) & 15, am[j]),
                          nf4::weight((p >> (8 + sh)) & 15, am[j + 1]));
      };
      a[0] = pair(ld(w + qmm::sw64(row, c)), 0) & live;
      a[1] = pair(ld(w + qmm::sw64(row + 8, c)), 0) & live;
      a[2] = pair(ld(w + qmm::sw64(row, c + 8)), 2) & live;
      a[3] = pair(ld(w + qmm::sw64(row + 8, c + 8)), 2) & live;
    }
  };
};

}  // namespace

// Launch on `stream`. dy: (M, N) bf16; packed: (K, N/2) uint8; absmax_q:
// (K/64 * N) uint8; absmax_scale: ceil(K/64 * N / 256) f32; absmax_offset:
// one f32 on the device; dx: (M, K) in out_dtype (0 f32, 1 bf16, 2 f16);
// every array 16-byte aligned. Requires M >= 1, K % 64 == 0, N % 64 == 0.
// Returns the first CUDA error of the descriptor encoding and the launch
// (0 on success).
extern "C" int nf4_matmul_bwd_launch(const void* dy, const void* packed,
                                     const void* absmax_q,
                                     const void* absmax_scale,
                                     const void* absmax_offset, void* dx,
                                     int M, int K, int N, int out_dtype,
                                     void* stream) {
  if (M < 1 || K % 64 || N % 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long n_scales = (static_cast<long>(K / 64) * N + 255) / 256;
  CUtensorMap tm_dy, tm_p, tm_aq, tm_as;
  cudaError_t err = qmm::encode_act(&tm_dy, dy, M, N);
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, K,
                         N / 2, qmm::kTileCols, qmm::kChunk,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_aq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, absmax_q,
                         K / 64, N, qmm::kTileCols / 64, qmm::kChunk,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = qmm::encode_1d_f32(&tm_as, absmax_scale, n_scales, 8);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const qmm::QmmArgs args = {dx, M, K, N, out_dtype, 0, 0, 1024,
                             static_cast<const float*>(absmax_offset)};
  return static_cast<int>(qmm::launch_qmm<Nf4Dx>(
      tm_dy, tm_p, tm_aq, tm_as, args, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* nf4_bwd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
