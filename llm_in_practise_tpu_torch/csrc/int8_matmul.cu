// W8A16 int8 matmul for Hopper (sm_90a), forward and backward:
//   y  = (x @ q) * scale[n]              (int8_matmul_kernel)
//   dx = bf16(dy * scale[n]) @ q^T       (int8_matmul_bwd_kernel)
//
// Replaces the TPU kernels llm_in_practise_tpu/ops/int8_matmul.py::_fwd_kernel
// (launched by _int8_matmul_fwd through pl.pallas_call) and ::_bwd_kernel
// (_int8_matmul_bwd). They compute the same functions with the same rounding
// points:
//   - q is an Int8Tensor's (K, N) int8 in [-127, 127] and scale its (N,) f32
//     per-column scale; int8 -> bf16 is exact.
//   - Forward: x is bf16 (the wrapper casts), products accumulate in f32, and
//     the scale multiplies the f32 sum once per output element after the K
//     loop (after the split-K reduce where there is one), then one rounding
//     to the caller's dtype.
//   - Backward: dys = bf16(f32(dy) * scale) first (the JAX package scales in
//     f32 outside its kernel and rounds to bf16 inside it), then
//     dx = dys @ q^T with f32 sums. With a bf16 dy the kernel scales each
//     staged dy tile in shared memory; the wrapper forms dys itself for any
//     other dy dtype and passes no scale.
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16): at decode
// (M <= 8) the forward is bound by bytes, 1 byte per weight; at training
// widths (M = 8192) both directions by the 2*M*K*N tensor-core operations.
//
// What the design does about that bound:
//   - Forward: the pair (k, k + 1) of one column, which one 32-bit B-fragment
//     register of mma.sync m16n8k16 holds, lies N bytes apart in row-major
//     q; the tile is staged in shared memory (16-byte cp.async copies,
//     coalesced rows) and the pairs are built there, so the bf16 weight
//     never exists in device memory. A cp.async ring keeps several chunks in
//     flight; thin M splits K over grid.z as the NF4 and int4 kernels do,
//     with a deterministic second pass that sums and applies the scale.
//   - Backward: for fixed k the pair (n, n + 1) is two adjacent bytes of q,
//     which is the reduction pair the fragment wants: one 16-bit shared
//     load per register. A block owns a 64 x 64 dx tile and reduces over
//     all of N inside the block (no atomics, deterministic). The scale is
//     applied once per staged dy element, not once per warp that reads it.
//   - The M, N and K edges are masked (zero-filled tiles, guarded stores).
// wgmma and TMA are left for a later version; this one uses mma.sync
// m16n8k16 (bf16 in, f32 accumulate).

#include "mma_util.cuh"

namespace {

using port::mma_bf16;
using port::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // 4 warps
// forward
constexpr int kBK = 64;             // K rows per chunk
constexpr int kBN = 64;             // output columns per block, 16 per warp
constexpr int kQStride = kBN + 16;  // smem bytes per q row (bank spread)
constexpr int kXStride = kBK + 8;   // smem bf16 per x row (bank spread)
// backward
constexpr int kBM = 64;               // dy rows per block
constexpr int kBDX = 64;              // dx columns (q rows) per block
constexpr int kBR = 32;               // reduction (N) columns per chunk
constexpr int kBStages = 3;
constexpr int kBQStride = kBR + 16;   // smem bytes per q row
constexpr int kDStride = kBR + 8;     // smem bf16 per dy row

__device__ __forceinline__ float i8f(int8_t v) {
  return static_cast<float>(v);
}

// One block: rows [m0, m0 + 16*MT) of x against output columns
// [n0, n0 + kBN), over the K chunks of split blockIdx.z. Warp w owns
// columns n0 + 16w .. n0 + 16w + 15 as two n8 tiles.
template <int MT, int STAGES>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, void* __restrict__ out,
                   float* __restrict__ ws, int M, int K, int N, int split_k,
                   int out_dtype) {
  constexpr int BM = 16 * MT;
  __shared__ __align__(16) int8_t s_q[STAGES][kBK * kQStride];
  __shared__ __align__(16) bf16 s_x[STAGES][BM * kXStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int n_chunks = (K + kBK - 1) / kBK;
  const int kc_begin =
      static_cast<int>(static_cast<long>(blockIdx.z) * n_chunks / split_k);
  const int kc_end =
      static_cast<int>(static_cast<long>(blockIdx.z + 1) * n_chunks / split_k);
  const int n_local = kc_end - kc_begin;
  const bool q_vec = (N % 16) == 0;  // 16-byte aligned q rows
  const bool x_vec = (K % 8) == 0;   // 16-byte aligned x rows

  auto load_stage = [&](int stage, int kc) {
    const int k0 = kc * kBK;
    // q tile: kBK rows x kBN bytes; zeros past the K and N edges
    for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16);
      const int part = i % (kBN / 16);
      const int row = k0 + r;
      const int col = n0 + part * 16;
      int8_t* dst = &s_q[stage][r * kQStride + part * 16];
      if (q_vec) {
        const bool ok = row < K && col < N;
        port::cp_async16(dst, q + (ok ? static_cast<long>(row) * N + col : 0),
                         ok ? 16 : 0);
      } else {
        for (int b = 0; b < 16; ++b) {
          dst[b] = (row < K && col + b < N)
                       ? q[static_cast<long>(row) * N + col + b]
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

  for (int i = 0; i < n_local; ++i) {
    port::cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nxt = i + STAGES - 1;
      if (nxt < n_local) load_stage(nxt % STAGES, kc_begin + nxt);
      port::cp_async_commit();
    }
    const int stage = i % STAGES;
    const int8_t* sq = s_q[stage] + warp * 16 + g;
    const bf16* sx = s_x[stage];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int r = ks * 16 + 2 * t;  // q rows r, r+1 (b0) and r+8, r+9 (b1)
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int8_t* qc = sq + nt * 8;
        b[nt][0] = pack_bf16(i8f(qc[r * kQStride]),
                             i8f(qc[(r + 1) * kQStride]));
        b[nt][1] = pack_bf16(i8f(qc[(r + 8) * kQStride]),
                             i8f(qc[(r + 9) * kQStride]));
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
            port::store_out(out, o, __fmul_rn(acc[mt][nt][e], scale[col]),
                            out_dtype);
          }
        }
      }
    }
  }
}

// Sum the split-K partials in split order, then apply the column scale.
__global__ void int8_splitk_reduce_kernel(const float* __restrict__ ws,
                                          const float* __restrict__ scale,
                                          void* __restrict__ out, long mn,
                                          int N, int split_k, int out_dtype) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < split_k; ++z) s += ws[z * mn + i];
  port::store_out(out, i, __fmul_rn(s, scale[i % N]), out_dtype);
}

struct __align__(16) BwdStage {
  int8_t q[kBDX * kBQStride];  // q rows k0 .. k0+63, 32 columns
  bf16 dy[kBM * kDStride];
  float scale[kBR];
};

// One block: the 64 x 64 tile dx[m0 .. m0+63, k0 .. k0+63], reducing over
// all of N. Warp w owns dx columns k0 + 16w .. k0 + 16w + 15 as two n8
// tiles. `scale` is null when the wrapper has already scaled dy.
__global__ void __launch_bounds__(kThreads)
int8_matmul_bwd_kernel(const bf16* __restrict__ dy,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ scale, void* __restrict__ dx,
                       int M, int K, int N, int out_dtype) {
  __shared__ BwdStage st[kBStages];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBDX;
  const int m0 = blockIdx.y * kBM;
  const int n_chunks = (N + kBR - 1) / kBR;

  auto load_stage = [&](int s, int chunk) {
    const int c0 = chunk * kBR;
    BwdStage& S = st[s];
    {  // q: 64 rows x 32 bytes, one 16-byte copy per thread
      const int r = tid >> 1;
      const int part = tid & 1;
      const int row = k0 + r;
      const int col = c0 + part * 16;
      const bool ok = row < K && col < N;
      port::cp_async16(&S.q[r * kBQStride + part * 16],
                       q + (ok ? static_cast<long>(row) * N + col : 0),
                       ok ? 16 : 0);
    }
    // dy: 64 rows x 32 columns; zeros past the M and N edges
    for (int i = tid; i < kBM * (kBR / 8); i += kThreads) {
      const int r = i / (kBR / 8);
      const int part = i % (kBR / 8);
      const int row = m0 + r;
      const int col = c0 + part * 8;
      const bool ok = row < M && col < N;
      port::cp_async16(&S.dy[r * kDStride + part * 8],
                       dy + (ok ? static_cast<long>(row) * N + col : 0),
                       ok ? 16 : 0);
    }
    if (scale != nullptr && tid < kBR / 4) {  // 32 scales, 4 per copy
      const int col = c0 + tid * 4;
      const bool ok = col < N;
      port::cp_async16(&S.scale[tid * 4], scale + (ok ? col : 0),
                       ok ? 16 : 0);
    }
  };

  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kBStages - 1; ++s) {
    if (s < n_chunks) load_stage(s, s);
    port::cp_async_commit();
  }

  for (int i = 0; i < n_chunks; ++i) {
    port::cp_async_wait<kBStages - 2>();
    __syncthreads();
    {
      const int nxt = i + kBStages - 1;
      if (nxt < n_chunks) load_stage(nxt % kBStages, nxt);
      port::cp_async_commit();
    }
    BwdStage& S = st[i % kBStages];
    if (scale != nullptr) {
      // dys = bf16(f32(dy) * scale), once per staged element
      for (int j = tid; j < kBM * (kBR / 2); j += kThreads) {
        const int r = j / (kBR / 2);
        const int c = 2 * (j % (kBR / 2));
        __nv_bfloat162* p =
            reinterpret_cast<__nv_bfloat162*>(&S.dy[r * kDStride + c]);
        const float2 v = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(__fmul_rn(v.x, S.scale[c]),
                                   __fmul_rn(v.y, S.scale[c + 1]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int ks = 0; ks < kBR / 16; ++ks) {
      const int c = ks * 16 + 2 * t;  // reduction columns c, c+1, c+8, c+9
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int8_t* qrow = &S.q[(warp * 16 + nt * 8 + g) * kBQStride];
        b[nt][0] = pack_bf16(i8f(qrow[c]), i8f(qrow[c + 1]));
        b[nt][1] = pack_bf16(i8f(qrow[c + 8]), i8f(qrow[c + 9]));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* da = &S.dy[(mt * 16 + g) * kDStride + c];
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
  port::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = k0 + warp * 16 + nt * 8 + 2 * t + (e & 1);
        if (row < M && col < K) {
          port::store_out(dx, static_cast<long>(row) * K + col,
                          acc[mt][nt][e], out_dtype);
        }
      }
    }
  }
}

}  // namespace

// Forward, on `stream`. x: (M, K) bf16, 16-byte aligned; q: (K, N) int8;
// scale: (N,) f32; out: (M, N) in out_dtype (0 f32, 1 bf16, 2 f16); ws:
// (split_k, M, N) f32 when split_k > 1. Requires M >= 1. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int int8_matmul_launch(const void* x, const void* q,
                                  const void* scale, void* out, void* ws,
                                  int M, int K, int N, int split_k,
                                  int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sc = static_cast<const float*>(scale);
  auto* wsf = static_cast<float*>(ws);
  if (M <= 16) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16, split_k);
    int8_matmul_kernel<1, 4><<<grid, block, 0, s>>>(
        xb, qb, sc, out, wsf, M, K, N, split_k, out_dtype);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64, split_k);
    int8_matmul_kernel<4, 3><<<grid, block, 0, s>>>(
        xb, qb, sc, out, wsf, M, K, N, split_k, out_dtype);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split_k == 1) return static_cast<int>(err);
  const long mn = static_cast<long>(M) * N;
  int8_splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                              s>>>(wsf, sc, out, mn, N, split_k, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// Backward, on `stream`. dy: (M, N) bf16, 16-byte aligned; q: (K, N) int8;
// scale: (N,) f32, 16-byte aligned, or null when dy is already scaled; dx:
// (M, K) in out_dtype. Requires M >= 1, N % 16 == 0. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_matmul_bwd_launch(const void* dy, const void* q,
                                      const void* scale, void* dx, int M,
                                      int K, int N, int out_dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((K + kBDX - 1) / kBDX, (M + kBM - 1) / kBM);
  int8_matmul_bwd_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(dy), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), dx, M, K, N, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
