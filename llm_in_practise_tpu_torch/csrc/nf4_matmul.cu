// Fused NF4 dequant-matmul for Hopper (sm_90a): y = x @ dequant_nf4(W),
//   qmm_wgmma_kernel<Nf4Fwd> at prefill and training row counts;
//   nf4_matmul_kernel, split over K, at decode.
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
//     to fill 132 SMs: nf4_matmul_kernel (mma.sync m16n8k16 on 16-row tiles,
//     a cp.async ring of packed and x tiles) splits K over grid.z; each split
//     writes f32 partials to a workspace and a second kernel sums them in a
//     fixed order (deterministic, no atomics). The split-half nibble pairing
//     means one packed byte column feeds one column of each output half:
//     each warp owns 8 byte columns and produces two n8 output tiles from
//     one load.

#include "mma_util.cuh"
#include "nf4_codec.cuh"
#include "qmm_wgmma.cuh"

namespace {

using port::cp_async16;
using port::cp_async_commit;
using port::cp_async_wait;
using port::mma_bf16;
using port::pack_bf16;
using port::store_out;

constexpr int kBK = 64;             // K rows per chunk == one absmax block
constexpr int kBNH = 32;            // packed byte columns per block
constexpr int kWarps = 4;           // each warp owns 8 byte columns
constexpr int kThreads = kWarps * 32;
constexpr int kPStride = kBNH + 16; // smem bytes per packed row (bank spread)
constexpr int kXStride = kBK + 8;   // smem bf16 per x row (bank spread)

// One block: rows [m0, m0 + 16*MT) of x against byte columns
// [c0, c0 + kBNH) of packed, i.e. output columns [c0, c0 + kBNH) and
// [N/2 + c0, N/2 + c0 + kBNH), over the K chunks of split blockIdx.z.
template <int MT, int STAGES>
__global__ void __launch_bounds__(kThreads)
nf4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ packed,
                  const uint8_t* __restrict__ aq,
                  const float* __restrict__ ascale,
                  const float* __restrict__ aoffset, void* __restrict__ out,
                  float* __restrict__ ws, int M, int K, int N, int split_k,
                  int out_dtype) {
  constexpr int BM = 16 * MT;
  __shared__ __align__(16) uint8_t s_p[STAGES][kBK * kPStride];
  __shared__ __align__(16) __nv_bfloat16 s_x[STAGES][BM * kXStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread in group
  const int NH = N >> 1;
  const int c0 = blockIdx.x * kBNH;
  const int m0 = blockIdx.y * BM;
  const int n_chunks = K / kBK;
  const int kc_begin =
      static_cast<int>(static_cast<long>(blockIdx.z) * n_chunks / split_k);
  const int kc_end =
      static_cast<int>(static_cast<long>(blockIdx.z + 1) * n_chunks / split_k);
  const int n_local = kc_end - kc_begin;
  const bool vec_ok = (NH % 16) == 0;

  nf4::fill_codebook();  // read after the loop's first __syncthreads
  const float offset = *aoffset;

  auto load_stage = [&](int stage, int kc) {
    const int k0 = kc * kBK;
    // packed tile: kBK rows x kBNH bytes, 16 bytes per copy
    for (int i = tid; i < kBK * (kBNH / 16); i += kThreads) {
      const int r = i / (kBNH / 16);
      const int part = i % (kBNH / 16);
      const int col = c0 + part * 16;
      uint8_t* dst = &s_p[stage][r * kPStride + part * 16];
      const uint8_t* src = packed + static_cast<long>(k0 + r) * NH + col;
      if (vec_ok && col + 16 <= NH) {
        cp_async16(dst, src, 16);
      } else {
        // ragged or unaligned edge: byte loads, zeros past the last column
        for (int b = 0; b < 16; ++b) dst[b] = (col + b < NH) ? src[b] : 0;
      }
    }
    // x tile: BM rows x kBK bf16; rows past M are zero-filled
    for (int i = tid; i < BM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8);
      const int part = i % (kBK / 8);
      const int row = m0 + r;
      __nv_bfloat16* dst = &s_x[stage][r * kXStride + part * 8];
      const __nv_bfloat16* src =
          x + static_cast<long>(row < M ? row : M - 1) * K + k0 + part * 8;
      cp_async16(dst, src, row < M ? 16 : 0);
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
    cp_async_commit();
  }

  const int bcol = c0 + warp * 8 + g;  // this thread's B (byte) column
  const bool bcol_ok = bcol < NH;

  for (int i = 0; i < n_local; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nxt = i + STAGES - 1;
      if (nxt < n_local) load_stage(nxt % STAGES, kc_begin + nxt);
      cp_async_commit();
    }
    const int stage = i % STAGES;
    const int kb = kc_begin + i;  // absmax block row of this chunk
    float am_hi = 0.0f;
    float am_lo = 0.0f;
    if (bcol_ok) {
      const long j = static_cast<long>(kb) * N + bcol;
      am_hi = nf4::absmax(aq[j], ascale[j >> 8], offset);
      am_lo = nf4::absmax(aq[j + NH], ascale[(j + NH) >> 8], offset);
    }
    const uint8_t* sp = s_p[stage] + warp * 8 + g;
    const __nv_bfloat16* sx = s_x[stage];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int r = ks * 16 + 2 * t;
      const uint32_t p0 = sp[r * kPStride];
      const uint32_t p1 = sp[(r + 1) * kPStride];
      const uint32_t p2 = sp[(r + 8) * kPStride];
      const uint32_t p3 = sp[(r + 9) * kPStride];
      const uint32_t bh0 = pack_bf16(nf4::weight(p0 >> 4, am_hi),
                                     nf4::weight(p1 >> 4, am_hi));
      const uint32_t bh1 = pack_bf16(nf4::weight(p2 >> 4, am_hi),
                                     nf4::weight(p3 >> 4, am_hi));
      const uint32_t bl0 = pack_bf16(nf4::weight(p0 & 15, am_lo),
                                     nf4::weight(p1 & 15, am_lo));
      const uint32_t bl1 = pack_bf16(nf4::weight(p2 & 15, am_lo),
                                     nf4::weight(p3 & 15, am_lo));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xa =
            sx + (mt * 16 + g) * kXStride + ks * 16 + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xa);
        a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * kXStride);
        a[2] = *reinterpret_cast<const uint32_t*>(xa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * kXStride + 8);
        mma_bf16(acc[mt][0], a, bh0, bh1);
        mma_bf16(acc[mt][1], a, bl0, bl1);
      }
    }
  }
  cp_async_wait<0>();

  const long mn = static_cast<long>(M) * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int bc = c0 + warp * 8 + 2 * t + (e & 1);
        if (row < M && bc < NH) {
          const long o = static_cast<long>(row) * N + (h ? NH : 0) + bc;
          if (split_k > 1) {
            ws[blockIdx.z * mn + o] = acc[mt][h][e];
          } else {
            store_out(out, o, acc[mt][h][e], out_dtype);
          }
        }
      }
    }
  }
}

// Sum the split-K partials in split order and write the output dtype.
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     void* __restrict__ out, long mn,
                                     int split_k, int out_dtype) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < split_k; ++z) s += ws[z * mn + i];
  store_out(out, i, s, out_dtype);
}

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

}  // namespace

// Launch on `stream`. x: (M, K) bf16; packed: (K, N/2) uint8; absmax_q:
// (K/64 * N) uint8; absmax_scale: f32; absmax_offset: one f32 on the device;
// out: (M, N) in out_dtype (0 f32, 1 bf16, 2 f16); ws: (split_k, M, N) f32
// when split_k > 1. Requires M >= 1, K % 64 == 0, N even, 16-byte aligned
// x. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int nf4_matmul_launch(const void* x, const void* packed,
                                 const void* absmax_q,
                                 const void* absmax_scale,
                                 const void* absmax_offset, void* out,
                                 void* ws, int M, int K, int N, int split_k,
                                 int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NH = N / 2;
  const dim3 block(kThreads);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pb = static_cast<const uint8_t*>(packed);
  const auto* aqb = static_cast<const uint8_t*>(absmax_q);
  const auto* asb = static_cast<const float*>(absmax_scale);
  const auto* aob = static_cast<const float*>(absmax_offset);
  auto* wsf = static_cast<float*>(ws);
  if (M <= 16) {
    const dim3 grid((NH + kBNH - 1) / kBNH, (M + 15) / 16, split_k);
    nf4_matmul_kernel<1, 4><<<grid, block, 0, s>>>(
        xb, pb, aqb, asb, aob, out, wsf, M, K, N, split_k, out_dtype);
  } else {
    const dim3 grid((NH + kBNH - 1) / kBNH, (M + 63) / 64, split_k);
    nf4_matmul_kernel<4, 3><<<grid, block, 0, s>>>(
        xb, pb, aqb, asb, aob, out, wsf, M, K, N, split_k, out_dtype);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split_k == 1) return static_cast<int>(err);
  const long mn = static_cast<long>(M) * N;
  splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      wsf, out, mn, split_k, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// Launch the wgmma route (Nf4Fwd) on `stream`: x, packed, absmax_q,
// absmax_scale, absmax_offset and out as for nf4_matmul_launch, every array
// 16-byte aligned. Requires M >= 1, K % 64 == 0 and N % 32 == 0 (the
// low-half absmax runs and the packed rows, N/2 bytes, must start 16-byte
// aligned for TMA). Returns the first CUDA error of the descriptor encoding
// and the launch (0 on success).
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

extern "C" const char* nf4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
