// Fused NF4 dequant-matmul for Hopper (sm_90a): y = x @ dequant_nf4(W),
//   qmm_wgmma_kernel<Nf4Fwd> at prefill and training row counts;
//   qmm_thin_kernel<Nf4Thin> (csrc/qmm_thin.cuh) at decode and short
//   prefill row counts.
//
// Replaces the TPU kernel llm_in_practise_tpu/ops/nf4_matmul.py::_fwd_kernel
// (launched by _call_fwd through pl.pallas_call). It computes the same
// function, with the same rounding points, and is not carried over block by
// block:
//   - W is an NF4Tensor in "kblock" layout: packed (K, N/2) uint8, where byte
//     [k, i] holds code[k, i] (high nibble) and code[k, N/2 + i] (low
//     nibble); absmax blocks of 64 rows run along K and are double-quantized
//     (absmax_q uint8 (K/64, N), absmax_scale f32 per 256 flat absmax
//     values, absmax_offset f32).
//   - x is bf16 (the wrapper casts); each weight is code * absmax in f32,
//     rounded once to bf16; products accumulate in f32; the output is
//     written in the caller's dtype. The decode is nf4_codec.cuh's, shared
//     with the backward (csrc/nf4_matmul_bwd.cu).
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16): at decode
// (M <= 8) the call is bound by bytes, K*N/2 packed bytes plus K*N/64
// absmax bytes, i.e. ~4.13 bits per weight; at prefill and training widths
// (M in the hundreds and up) by the 2*M*K*N tensor-core operations (3.196 ms
// for one Qwen3-8B layer's 7 projections at M = 8192).
//
// What the design does about that bound:
//   - Both kernels read the packed bytes and the double-quantized absmax
//     themselves (no f32 absmax is made beforehand), so the weight stream
//     stays at ~4.13 bits per parameter, and dequantize in registers
//     straight into tensor-core fragments: the bf16 weight never exists in
//     device or shared memory.
//   - From the wrapper's row threshold up (ops/nf4_matmul.py::_route), the
//     shared wgmma mainloop of qmm_wgmma.cuh (TMA ring, one producer thread,
//     two consumer warpgroups on a 128 x 256 tile of y^T, the whole of K
//     reduced in the block: deterministic) with the Nf4Fwd policy, as
//     y^T = W^T . x^T. A block takes 64 packed byte columns; warpgroup 0
//     decodes their high nibbles (output columns b0 ..), warpgroup 1 the low
//     ones (N/2 + b0 ..), so the nibble is uniform per warpgroup and the
//     epilogue's column map (out_col) places the two 64-column ranges. A
//     stage is 64 k, exactly one absmax row: each thread's two columns take
//     two absmax values per stage. The mma.sync split-K kernel took 18.86 ms
//     for one layer's 7 projections at M = 8192, 4.8x cuBLAS on a
//     dequantized weight (NVIDIA H100 80GB HBM3, 700 W).
//   - Thin M (decode) leaves a 256-row tile mostly empty and too few blocks
//     to fill 132 SMs: below the threshold the thin-M streaming kernel of
//     qmm_thin.cuh with the Nf4Thin policy (below), shared with the int4
//     and int8 forwards: a producer warp streams 128-k stages of packed
//     bytes, absmax bytes and scales by TMA, eight consumer warps decode
//     them into mma.sync A fragments (the weight is the A operand, so 8
//     rows of x fill an n8 tile), and the K splits of a column slab are
//     summed in a thread-block cluster through distributed shared memory:
//     one launch, no workspace, deterministic. The split-K kernel it
//     replaced (16-row x tiles, f32 partials in device memory summed by a
//     second launch) took 0.1588 ms of device time for one layer's 7
//     projections at M = 8 (NVIDIA H100 80GB HBM3, 700 W).

#include "mma_util.cuh"
#include "nf4_codec.cuh"
#include "qmm_thin.cuh"
#include "qmm_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// B1's decode policy for the quantized-matmul mainloop (qmm_wgmma.cuh) at
// prefill and training row counts, as y^T = W^T . x^T: A is W^T, its rows
// the output columns n, its reduction k. Block x takes packed byte columns
// b0 = 64 x .. b0 + 63: tile columns 0-63 are output columns b0 .. (high
// nibbles, warpgroup 0), 64-127 are N/2 + b0 .. (low nibbles, warpgroup 1).
// A stage is 64 k, exactly one absmax row kb = i: the packed box, 64 rows x
// 64 bytes (TMA, 64-byte swizzle); then the aux bytes: for each half h, the
// 64-byte absmax_q run of row kb at column h N/2 + b0 (at 128 h) and that
// run's 8 absmax scales from the 16-byte-aligned index at or below its first
// scale block (at kScaleOff + 128 h; TMA faults on a box whose innermost
// start is not 16-byte aligned, hence N % 32 == 0). Fragment rows g and
// g + 8 of warp w are the adjacent byte columns c = 16 w + 2 g and c + 1, so
// one 16-bit load of packed row k gives both columns' codes at k; their
// absmax bytes are adjacent too and share one scale (a 256-value scale block
// starts at an even flat index, and the run's start is even). Byte columns
// past N/2 (the last block where N/2 % 64 != 0) decode zero-filled bytes
// into their own A rows only, whose output columns out_col drops.
struct Nf4Fwd : qmm::LinearChunks {
  static constexpr uint32_t kWBytes = qmm::kChunk * 64;
  static constexpr int kScaleOff = 256;  // bytes into the aux area

  __device__ static uint32_t tx_bytes(const qmm::QmmArgs&) {
    return kWBytes + 2 * 64 + 2 * 8 * 4;
  }

  // flat absmax index of half h's first column in absmax row kb
  __device__ static int run_flat(int kb, int h, int b0, int n) {
    return kb * n + h * (n / 2) + b0;
  }

  __device__ static void load(uint8_t* w, const CUtensorMap* tm_packed,
                              const CUtensorMap* tm_aq,
                              const CUtensorMap* tm_ascale, uint64_t* bar,
                              int i, int c0, const qmm::QmmArgs& args) {
    const int b0 = c0 / 2;
    uint8_t* aux = w + kWBytes;
    qmm::tma_load_2d(w, tm_packed, bar, b0, i * qmm::kChunk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qmm::tma_load_2d(aux + 128 * h, tm_aq, bar, h * (args.cols / 2) + b0,
                       i);
      qmm::tma_load_1d(aux + kScaleOff + 128 * h, tm_ascale, bar,
                       (run_flat(i, h, b0, args.cols) >> 8) & ~3);
    }
  }

  __device__ static int col_local(int wg, int warp, int g, int hi) {
    return 64 * wg + 16 * warp + 2 * g + hi;
  }

  __device__ static int out_col(int block_x, int cc,
                                const qmm::QmmArgs& args) {
    const int nh = args.cols / 2;
    const int b = 64 * block_x + (cc & 63);
    return b < nh ? b + (cc >= 64 ? nh : 0) : -1;
  }

  struct State {
    int c, t, wg, sh, b0, n;
    float offset;
    __device__ State(const qmm::QmmArgs& args, int c0, int wg_, int warp,
                     int g, int t_)
        : c(16 * warp + 2 * g),
          t(t_),
          wg(wg_),
          sh(wg_ == 0 ? 4 : 0),
          b0(c0 / 2),
          n(args.cols),
          offset(*args.param) {
      nf4::fill_codebook();
      qmm::consumer_sync();
    }

    __device__ void decode(const uint8_t* w, const float* auxf, int i, int ks,
                           uint32_t (&a)[4]) const {
      const auto* aux = reinterpret_cast<const uint8_t*>(auxf);
      const auto ld = [](const uint8_t* p) {
        return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
      };
      const int flat = run_flat(i, wg, b0, n);
      const float scale = reinterpret_cast<const float*>(
          aux + kScaleOff + 128 * wg)[((flat + c) >> 8) - ((flat >> 8) & ~3)];
      const uint32_t q = ld(aux + 128 * wg + c);
      const float am0 = nf4::absmax(q & 255, scale, offset);
      const float am1 = nf4::absmax(q >> 8, scale, offset);
      // byte j (column c + j) of a 16-bit load: this warpgroup's nibble
      const auto wt = [&](uint32_t p, int j, float am) {
        return nf4::weight((p >> (8 * j + sh)) & 15, am);
      };
      const int r = 16 * ks + 2 * t;
      const uint32_t p0 = ld(w + qmm::sw64(r, c));
      const uint32_t p1 = ld(w + qmm::sw64(r + 1, c));
      const uint32_t p8 = ld(w + qmm::sw64(r + 8, c));
      const uint32_t p9 = ld(w + qmm::sw64(r + 9, c));
      a[0] = qmm::pack2(wt(p0, 0, am0), wt(p1, 0, am0));
      a[1] = qmm::pack2(wt(p0, 1, am1), wt(p1, 1, am1));
      a[2] = qmm::pack2(wt(p8, 0, am0), wt(p9, 0, am0));
      a[3] = qmm::pack2(wt(p8, 1, am1), wt(p9, 1, am1));
    }
  };
};

// B1's policy for the thin-M kernel of qmm_thin.cuh (decode and short
// prefill row counts). A slab is 64 packed byte columns b0 = 64 slab ..
// b0 + 63: local columns 0-63 are their high nibbles (output columns b0 ..),
// 64-127 their low ones (N/2 + b0 ..), so column groups 0-1 decode high
// nibbles and 2-3 low ones, the nibble uniform per warp, and out_col places
// the two ranges.
//   - A stage is 128 k, two absmax rows: the packed box, 128 rows x 64 bytes
//     (64-byte swizzle); then the aux bytes: for each half h the absmax_q
//     runs of rows kb and kb + 1 at column h N/2 + b0 (64 bytes each, at
//     128 h), and for each half and row the 8 absmax scales from the
//     16-byte-aligned index at or below the run's first scale block (at
//     kScaleOff + 128 (2 h + row): a TMA box lands 128-byte aligned in
//     shared memory, and faults on an innermost start that is not 16-byte
//     aligned). The TMA path needs N % 32 == 0 (a packed row and the low
//     half's runs start 16-byte aligned); the plain path fills the same
//     layout with byte loads (N = 200, say).
//   - Thread (g, t) owns byte columns c .. c + 3 of its half: one 32-bit
//     load of packed row k gives the 4 columns' codes at k, one of row
//     k + 1 the other half of each pair. One rotate and one mask per word
//     leave each byte holding 4 x its code (this warp's nibble), and one
//     byte permute per weight picks it out as the codebook offset. The
//     warp's k half is exactly one absmax row, so each stage it decodes the
//     4 columns' absmax once.
//   - Past K (a last stage over a K that is 64 mod 128) the packed bytes,
//     absmax bytes and x read as zeros: code 0 is -1.0, but the absmax
//     stays finite and the x it meets is zero. Byte columns past N/2
//     decode bytes of their own or zeros into their own columns, which
//     out_col drops.
struct Nf4Thin {
  static constexpr int kBytes = thin::kBN / 2;  // packed byte columns a slab
  static constexpr int kWBytes = thin::kKC * kBytes;
  static constexpr int kScaleOff = 256;         // bytes into the aux area
  static constexpr int kAuxBytes = kScaleOff + 2 * 2 * 128;

  __host__ __device__ static constexpr int stages(int mt) {
    return mt <= 2 ? 6 : mt <= 4 ? 4 : 3;
  }
  __host__ __device__ static constexpr int min_blocks(int mt) {
    return mt <= 2 ? 3 : mt <= 4 ? 2 : 1;
  }
  __host__ __device__ static int aux_bytes(const thin::ThinArgs&) {
    return kAuxBytes;
  }
  __host__ __device__ static int slabs(int n) {
    return (n / 2 + kBytes - 1) / kBytes;
  }
  __device__ static int out_col(int slab, int lc, const thin::ThinArgs& args) {
    const int nh = args.N / 2;
    const int b = slab * kBytes + (lc & (kBytes - 1));
    return b < nh ? b + (lc >= kBytes ? nh : 0) : -1;
  }
  __device__ static void block_init() { nf4::fill_codebook(); }

  // the packed box, 2 x 2 absmax runs of 64 bytes, 2 x 2 scale runs of 8
  __device__ static uint32_t tx_bytes(const thin::ThinArgs&) {
    return kWBytes + 2 * 2 * 64 + 2 * 2 * 8 * 4;
  }

  // flat absmax index of half h's first column in absmax row kb
  __device__ static int run_flat(int kb, int h, int b0, int n) {
    return kb * n + h * (n / 2) + b0;
  }

  __device__ static void load(uint8_t* w, uint8_t* aux,
                              const CUtensorMap* tm_p,
                              const CUtensorMap* tm_aq,
                              const CUtensorMap* tm_as, uint64_t* bar,
                              int slab, int k0, const thin::ThinArgs& args) {
    const int b0 = slab * kBytes;
    const int kb = k0 / 64;
    qmm::tma_load_2d(w, tm_p, bar, b0, k0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qmm::tma_load_2d(aux + 128 * h, tm_aq, bar, h * (args.N / 2) + b0, kb);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        qmm::tma_load_1d(aux + kScaleOff + 128 * (2 * h + r), tm_as, bar,
                         (run_flat(kb + r, h, b0, args.N) >> 8) & ~3);
    }
  }

  // the same layout by plain loads: packed bytes as TMA's 64-byte swizzle
  // writes them, zeros past K and N/2; absmax bytes and scales, zeros past
  // their arrays
  __device__ static void fill(uint8_t* w, uint8_t* aux, int lane, int slab,
                              int k0, const thin::ThinArgs& args) {
    const int b0 = slab * kBytes;
    const int nh = args.N / 2;
    for (int e = lane; e < kWBytes; e += 32) {
      const int r = e / kBytes;
      const int c = e % kBytes;
      const int row = k0 + r;
      w[qmm::sw64(r, c)] = (row < args.K && b0 + c < nh)
                               ? args.w[static_cast<long>(row) * nh + b0 + c]
                               : 0;
    }
    const int kb = k0 / 64;
    const auto* aq = static_cast<const uint8_t*>(args.aux0);
    const auto* as = static_cast<const float*>(args.aux1);
    for (int e = lane; e < 256; e += 32) {
      const int h = e / 128;
      const int r = (e / 64) % 2;
      const int col = h * nh + b0 + e % 64;
      aux[e] = (kb + r < args.K / 64 && col < args.N)
                   ? aq[static_cast<long>(kb + r) * args.N + col]
                   : 0;
    }
    {
      const int h = lane / 16;
      const int r = (lane / 8) % 2;
      const int i = ((run_flat(kb + r, h, b0, args.N) >> 8) & ~3) + lane % 8;
      reinterpret_cast<float*>(aux + kScaleOff + 128 * (2 * h + r))[lane % 8] =
          i < args.n_groups ? as[i] : 0.0f;
    }
  }

  struct State {
    int h, c, rot, kh, b0, o0, o1;
    float offset;
    float am[4];

    __device__ State(const thin::ThinArgs& args, int slab, int cl, int kh_,
                     int, int t)
        : h(cl / kBytes),
          c(cl % kBytes),
          // a rotation that takes this warp's nibble of each byte (high:
          // bits 4-7, low: bits 0-3) to bits 2-5, four times its code
          rot(cl < kBytes ? 2 : 30),
          kh(kh_),
          b0(slab * kBytes),
          o0(qmm::sw64(2 * t, cl % kBytes)),
          o1(qmm::sw64(2 * t + 1, cl % kBytes)),
          offset(*args.param) {}

    // the absmax of the thread's 4 columns in its k half's absmax row
    template <bool kFast>
    __device__ void stage(const uint8_t* aux, int k0,
                          const thin::ThinArgs& args) {
      const int flat = run_flat(k0 / 64 + kh, h, b0, args.N);
      const float* sc = reinterpret_cast<const float*>(
          aux + kScaleOff + 128 * (2 * h + kh));
      const int s0 = (flat >> 8) & ~3;  // the staged run's first scale
      const uint32_t q4 =
          *reinterpret_cast<const uint32_t*>(aux + 128 * h + 64 * kh + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        am[e] = nf4::absmax((q4 >> (8 * e)) & 255,
                            sc[((flat + c + e) >> 8) - s0], offset);
    }

    template <bool kFast>
    __device__ void decode(const uint8_t* w, const uint8_t*, int ks, int,
                           const thin::ThinArgs&, uint32_t (&a)[2][4]) const {
      // rows 16 ks + ..: 1024 bytes a k-step, the swizzle repeats every 8
      // rows, and rows + 8 lie 512 bytes on
      const uint8_t* rows = w + 1024 * ks;
      // per byte of a 32-bit load (4 columns at one k): this warp's code
      // times 4, the byte offset into the codebook
      const auto ld = [&](int o) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(rows + o);
        return __funnelshift_r(v, v, rot) & 0x3C3C3C3Cu;
      };
      const uint32_t w0 = ld(o0), w1 = ld(o1), w8 = ld(o0 + 512),
                     w9 = ld(o1 + 512);
      const auto wt = [&](uint32_t v, int e) {
        return nf4::weight_at(__byte_perm(v, 0, 0x4440 + e), am[e]);
      };
#pragma unroll
      for (int ta = 0; ta < 2; ++ta) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * ta + e;
          a[ta][e] = qmm::pack2(wt(w0, col), wt(w1, col));
          a[ta][2 + e] = qmm::pack2(wt(w8, col), wt(w9, col));
        }
      }
    }
  };
};

}  // namespace

// Launch the wgmma route (Nf4Fwd) on `stream`. x: (M, K) bf16; packed:
// (K, N/2) uint8; absmax_q: (K/64 * N) uint8; absmax_scale: f32;
// absmax_offset: one f32 on the device; out: (M, N) in out_dtype (0 f32,
// 1 bf16, 2 f16); every array 16-byte aligned. Requires M >= 1, K % 64 == 0
// and N % 32 == 0 (the low-half absmax runs and the packed rows, N/2 bytes,
// must start 16-byte aligned for TMA). Returns the first CUDA error of the
// descriptor encoding and the launch (0 on success).
extern "C" int nf4_matmul_wgmma_launch(const void* x, const void* packed,
                                       const void* absmax_q,
                                       const void* absmax_scale,
                                       const void* absmax_offset, void* out,
                                       int M, int K, int N, int out_dtype,
                                       void* stream) {
  if (M < 1 || K % 64 || N % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long n_scales = (static_cast<long>(K / 64) * N + 255) / 256;
  CUtensorMap tm_x, tm_p, tm_aq, tm_as;
  cudaError_t err = qmm::encode_act(&tm_x, x, M, K);
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, K,
                         N / 2, qmm::kChunk, 64, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_aq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, absmax_q,
                         K / 64, N, 1, 64, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = qmm::encode_1d_f32(&tm_as, absmax_scale, n_scales, 8);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const qmm::QmmArgs args = {out, M, N, K, out_dtype, 0, 0, 1024,
                             static_cast<const float*>(absmax_offset)};
  return static_cast<int>(qmm::launch_qmm<Nf4Fwd>(
      tm_x, tm_p, tm_aq, tm_as, args, static_cast<cudaStream_t>(stream)));
}

// Launch the thin-M route (qmm_thin_kernel<Nf4Thin>) on `stream`: x,
// packed, absmax_q, absmax_scale, absmax_offset and out as for
// nf4_matmul_wgmma_launch, every array 16-byte aligned. Requires M >= 1,
// K % 64 == 0 and an even N; the TMA path takes N % 32 == 0, the plain-load
// path the rest. One launch (a cluster per column slab), no workspace.
// Returns the first CUDA error of the descriptor encoding and the launch (0
// on success).
extern "C" int nf4_matmul_thin_launch(const void* x, const void* packed,
                                      const void* absmax_q,
                                      const void* absmax_scale,
                                      const void* absmax_offset, void* out,
                                      int M, int K, int N, int out_dtype,
                                      void* stream) {
  if (M < 1 || K < 64 || K % 64 || N < 2 || N % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long n_scales = (static_cast<long>(K / 64) * N + 255) / 256;
  const bool fast = N % 32 == 0;
  thin::ThinArgs args = {};
  args.x = static_cast<const bf16*>(x);
  args.w = static_cast<const uint8_t*>(packed);
  args.aux0 = absmax_q;
  args.aux1 = absmax_scale;
  args.param = static_cast<const float*>(absmax_offset);
  args.out = out;
  args.M = M;
  args.K = K;
  args.N = N;
  args.out_dtype = out_dtype;
  args.n_groups = static_cast<int>(n_scales);
  CUtensorMap tm_p = {}, tm_aq = {}, tm_as = {};
  if (fast) {
    cudaError_t err = qmm::encode_2d(&tm_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                     packed, K, N / 2, thin::kKC,
                                     Nf4Thin::kBytes,
                                     CU_TENSOR_MAP_SWIZZLE_64B);
    if (err == cudaSuccess)
      err = qmm::encode_2d(&tm_aq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, absmax_q,
                           K / 64, N, 2, Nf4Thin::kBytes,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
      err = qmm::encode_1d_f32(&tm_as, absmax_scale, n_scales, 8);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(thin::launch<Nf4Thin>(
      tm_p, tm_aq, tm_as, args, fast, 0, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* nf4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
