// Fused NF4 dequant-matmul for Hopper (sm_90a): y = x @ dequant_nf4(W).
//
// Replaces the TPU kernel llm_in_practise_tpu/ops/nf4_matmul.py::_fwd_kernel
// (launched by _call_fwd through pl.pallas_call). It computes the same
// function, with the same rounding points, and is not carried over block by
// block:
//   - W is an NF4Tensor in "kblock" layout: packed (K, N/2) uint8, where byte
//     [k, i] holds code[k, i] (high nibble) and code[k, N/2 + i] (low
//     nibble); absmax blocks of 64 rows run along K and are double-quantized
//     (absmax_q uint8 (K/64 * N), absmax_scale f32 per 256 absmax values,
//     absmax_offset f32).
//   - x is bf16 (the wrapper casts); each weight is code * absmax in f32,
//     rounded once to bf16; products accumulate in f32; the output is
//     written in the caller's dtype.
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16): at decode
// (M <= 8) the call is bound by bytes, K*N/2 packed bytes plus K*N/64
// absmax bytes, i.e. ~4.13 bits per weight; at prefill widths (M in the
// hundreds) by the 2*M*K*N tensor-core operations.
//
// What the design does about that bound:
//   - The kernel reads the packed bytes and the double-quantized absmax
//     itself (no f32 absmax is made beforehand), so the weight stream stays
//     at ~4.13 bits per parameter, and it dequantizes in registers straight
//     into mma.sync B fragments: the bf16 weight never exists in device or
//     shared memory.
//   - Packed and x tiles stream through a cp.async ring of shared-memory
//     stages (16-byte copies, coalesced rows), so several chunks of each
//     block's weight slice are in flight while the tensor cores work.
//   - A thin M leaves few (M-tile, N-tile) blocks, too few to keep enough
//     bytes in flight on 132 SMs; the wrapper then splits K over grid.z.
//     Each split writes f32 partials to a workspace and a second kernel
//     sums them in a fixed order (deterministic, no atomics).
//   - The split-half nibble pairing means one packed byte column feeds one
//     column of the low output half and one of the high half: each warp
//     owns 8 byte columns and produces two n8 output tiles from one load.
//   - The 16-entry codebook sits in shared memory (no bank conflicts: 16
//     distinct words, equal indices broadcast); the TPU's select tree was a
//     Mosaic workaround.
//   - The absmax decode uses __fmul_rn/__fadd_rn so nvcc cannot contract it
//     into an FMA, which would round differently from the reference codec.
// wgmma and TMA are left for a later version; this one uses mma.sync
// m16n8k16 (bf16 in, f32 accumulate).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;             // K rows per chunk == one absmax block
constexpr int kBNH = 32;            // packed byte columns per block
constexpr int kWarps = 4;           // each warp owns 8 byte columns
constexpr int kThreads = kWarps * 32;
constexpr int kPStride = kBNH + 16; // smem bytes per packed row (bank spread)
constexpr int kXStride = kBK + 8;   // smem bf16 per x row (bank spread)

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even); `lo` takes
// the low 16 bits, i.e. the smaller k index of the fragment pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// double-quantized absmax j: (q - 128) * scale[j / 256] + offset, each step
// rounded on its own as the reference codec does
__device__ __forceinline__ float absmax_at(const uint8_t* __restrict__ aq,
                                           const float* __restrict__ ascale,
                                           float offset, long j) {
  float q = __fsub_rn(static_cast<float>(aq[j]), 128.0f);
  return __fadd_rn(__fmul_rn(q, ascale[j >> 8]), offset);
}

__device__ __forceinline__ void store_out(void* out, long i, float v,
                                          int out_dtype) {
  if (out_dtype == 1) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else if (out_dtype == 2) {
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

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
  __shared__ float s_code[16];

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

  if (tid < 16) s_code[tid] = kNF4[tid];
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
      am_hi = absmax_at(aq, ascale, offset, j);
      am_lo = absmax_at(aq, ascale, offset, j + NH);
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
      const uint32_t bh0 = pack_bf16(__fmul_rn(s_code[p0 >> 4], am_hi),
                                     __fmul_rn(s_code[p1 >> 4], am_hi));
      const uint32_t bh1 = pack_bf16(__fmul_rn(s_code[p2 >> 4], am_hi),
                                     __fmul_rn(s_code[p3 >> 4], am_hi));
      const uint32_t bl0 = pack_bf16(__fmul_rn(s_code[p0 & 15], am_lo),
                                     __fmul_rn(s_code[p1 & 15], am_lo));
      const uint32_t bl1 = pack_bf16(__fmul_rn(s_code[p2 & 15], am_lo),
                                     __fmul_rn(s_code[p3 & 15], am_lo));
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

extern "C" const char* nf4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
