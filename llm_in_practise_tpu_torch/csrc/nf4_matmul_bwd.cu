// NF4 dequant-matmul backward for Hopper (sm_90a): dx = dy @ dequant_nf4(W)^T.
//
// Replaces the TPU kernel llm_in_practise_tpu/ops/nf4_matmul.py::_bwd_kernel
// (launched by _call_bwd through pl.pallas_call). The QLoRA base is frozen,
// so only dx exists: there is no dW. It reads the same bytes as the forward
// kernel (csrc/nf4_matmul.cu): W is an NF4Tensor in "kblock" layout, packed
// (K, N/2) uint8 where byte [k, i] holds code[k, i] (high nibble) and
// code[k, N/2 + i] (low nibble); absmax blocks of 64 rows run along K and are
// double-quantized (absmax_q uint8 (K/64 * N), absmax_scale f32 per 256
// absmax values, absmax_offset f32).
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16): at training
// row counts (M = 8192) the 2*M*K*N tensor-core operations bound it by far
// (the packed weight is ~4.13 bits per parameter and dy/dx are read and
// written once).
//
// What the design does about that bound:
//   - One block owns a 64 x 64 tile of dx: 64 rows of dy against one absmax
//     block row of W (64 rows of K). It reduces over all of N inside the
//     block, so dx needs no atomics and no second pass, and is deterministic.
//   - W plays the transposed role: dx[m, k] = sum_n dy[m, n] * W[k, n], so
//     the mma B fragment for output column k and reduction index n is
//     W[k, n]. Split-half pairing means one packed byte column i feeds the
//     reduction index i (high nibble, against dy column i) and N/2 + i (low
//     nibble, against dy column N/2 + i): each packed chunk drives two mma
//     passes, one per half.
//   - Packed bytes, both dy column halves, the raw absmax bytes and their
//     two double-quant scales stream through a 3-stage cp.async ring; the
//     weight is dequantized in registers straight into bf16 B fragments and
//     never exists in device or shared memory in bf16.
//   - The decode arithmetic is exactly the forward kernel's (__fsub_rn,
//     __fmul_rn, __fadd_rn, then one rounding to bf16), so the kernel
//     differs from its plain version only in summation order.
// wgmma and TMA are left for a later version; this one uses mma.sync
// m16n8k16 (bf16 in, f32 accumulate).

#include "mma_util.cuh"

namespace {

using port::mma_bf16;
using port::pack_bf16;

constexpr int kBK = 64;              // dx columns (K) per block: one absmax row
constexpr int kBM = 64;              // dy rows per block
constexpr int kBNH = 32;             // packed byte columns per chunk
constexpr int kWarps = 4;            // warp w owns dx columns [16w, 16w + 16)
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kPStride = kBNH + 16;  // smem bytes per packed row (bank spread)
constexpr int kDStride = kBNH + 8;   // smem bf16 per dy half-row (bank spread)

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

struct __align__(16) Stage {
  uint8_t p[kBK * kPStride];               // packed rows k0..k0+63
  __nv_bfloat16 dy[2][kBM * kDStride];     // [half][row][col]
  uint8_t aq[2][kBNH];                     // raw absmax bytes per half
  float scale[2];                          // their double-quant scales
  float pad[2];
};

__global__ void __launch_bounds__(kThreads)
nf4_matmul_bwd_kernel(const __nv_bfloat16* __restrict__ dy,
                      const uint8_t* __restrict__ packed,
                      const uint8_t* __restrict__ aq,
                      const float* __restrict__ ascale,
                      const float* __restrict__ aoffset,
                      void* __restrict__ dx, int M, int K, int N,
                      int out_dtype) {
  __shared__ Stage st[kStages];
  __shared__ float s_code[16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int NH = N >> 1;
  const int k0 = blockIdx.x * kBK;
  const int kb = blockIdx.x;  // absmax block row of this tile
  const int m0 = blockIdx.y * kBM;
  const int n_chunks = NH / kBNH;

  if (tid < 16) s_code[tid] = kNF4[tid];
  const float offset = *aoffset;

  auto load_stage = [&](int s, int chunk) {
    const int c0 = chunk * kBNH;
    Stage& S = st[s];
    {  // packed: 64 rows x 32 bytes, one 16-byte copy per thread
      const int r = tid >> 1;
      const int part = tid & 1;
      port::cp_async16(&S.p[r * kPStride + part * 16],
                       packed + static_cast<long>(k0 + r) * NH + c0 + part * 16,
                       16);
    }
    // dy: 64 rows x 32 columns in each half; rows past M are zero-filled
    for (int i = tid; i < 2 * kBM * (kBNH / 8); i += kThreads) {
      const int half = i / (kBM * (kBNH / 8));
      const int rem = i % (kBM * (kBNH / 8));
      const int r = rem / (kBNH / 8);
      const int part = rem % (kBNH / 8);
      const int row = m0 + r;
      const __nv_bfloat16* src = dy +
          static_cast<long>(row < M ? row : M - 1) * N + half * NH + c0 +
          part * 8;
      port::cp_async16(&S.dy[half][r * kDStride + part * 8], src,
                       row < M ? 16 : 0);
    }
    if (tid < 4) {  // raw absmax bytes: 32 per half
      const int half = tid >> 1;
      const int part = tid & 1;
      port::cp_async16(
          &S.aq[half][part * 16],
          aq + static_cast<long>(kb) * N + half * NH + c0 + part * 16, 16);
    } else if (tid < 6) {  // a 32-aligned run of absmax shares one scale
      const int half = tid - 4;
      port::cp_async4(&S.scale[half],
                      ascale + ((static_cast<long>(kb) * N + half * NH + c0) >> 8),
                      4);
    }
  };

  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][kt][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_stage(s, s);
    port::cp_async_commit();
  }

  for (int i = 0; i < n_chunks; ++i) {
    port::cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nxt = i + kStages - 1;
      if (nxt < n_chunks) load_stage(nxt % kStages, nxt);
      port::cp_async_commit();
    }
    const Stage& S = st[i % kStages];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int shift = half ? 0 : 4;
      const float sc = S.scale[half];
#pragma unroll
      for (int ks = 0; ks < kBNH / 16; ++ks) {
        const int c = ks * 16 + 2 * t;  // byte columns c, c+1, c+8, c+9
        float am[4];
        const int cols[4] = {c, c + 1, c + 8, c + 9};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q = __fsub_rn(static_cast<float>(S.aq[half][cols[j]]),
                                    128.0f);
          am[j] = __fadd_rn(__fmul_rn(q, sc), offset);
        }
        uint32_t b[2][2];
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          const uint8_t* prow = &S.p[(warp * 16 + kt * 8 + g) * kPStride];
          float w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int code = (prow[cols[j]] >> shift) & 15;
            w[j] = __fmul_rn(s_code[code], am[j]);
          }
          b[kt][0] = pack_bf16(w[0], w[1]);
          b[kt][1] = pack_bf16(w[2], w[3]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const __nv_bfloat16* da =
              &S.dy[half][(mt * 16 + g) * kDStride + ks * 16 + 2 * t];
          uint32_t a[4];
          a[0] = port::ld_u32(da);
          a[1] = port::ld_u32(da + 8 * kDStride);
          a[2] = port::ld_u32(da + 8);
          a[3] = port::ld_u32(da + 8 * kDStride + 8);
          mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
          mma_bf16(acc[mt][1], a, b[1][0], b[1][1]);
        }
      }
    }
  }
  port::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = k0 + warp * 16 + kt * 8 + 2 * t + (e & 1);
        if (row < M) {
          port::store_out(dx, static_cast<long>(row) * K + col,
                          acc[mt][kt][e], out_dtype);
        }
      }
    }
  }
}

}  // namespace

// Launch on `stream`. dy: (M, N) bf16, 16-byte aligned; packed: (K, N/2)
// uint8; absmax_q: (K/64 * N) uint8; absmax_scale: f32; absmax_offset: one
// f32 on the device; dx: (M, K) in out_dtype (0 f32, 1 bf16, 2 f16).
// Requires M >= 1, K % 64 == 0, N % 64 == 0. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int nf4_matmul_bwd_launch(const void* dy, const void* packed,
                                     const void* absmax_q,
                                     const void* absmax_scale,
                                     const void* absmax_offset, void* dx,
                                     int M, int K, int N, int out_dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(K / kBK, (M + kBM - 1) / kBM);
  nf4_matmul_bwd_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const uint8_t*>(packed),
      static_cast<const uint8_t*>(absmax_q),
      static_cast<const float*>(absmax_scale),
      static_cast<const float*>(absmax_offset), dx, M, K, N, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nf4_bwd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
