// W8A16 int8 matmul for Hopper (sm_90a), forward and backward:
//   y  = (x @ q) * scale[n]              (qmm_wgmma_kernel<Int8Fwd> at
//                                         prefill and training row counts;
//                                         int8_matmul_kernel, split over K,
//                                         at decode)
//   dx = bf16(dy * scale[n]) @ q^T       (int8_scale_dy_kernel, then
//                                         qmm_wgmma_kernel<Int8Dx>)
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
//     dx = dys @ q^T with f32 sums. With a bf16 dy a first kernel forms dys
//     once, into the wrapper's scratch; the wrapper forms dys itself for any
//     other dy dtype and passes no scale.
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16): at decode
// (M <= 8) the forward is bound by bytes, 1 byte per weight; at training
// widths (M = 8192) both directions by the 2*M*K*N tensor-core operations
// (3.196 ms for one Qwen3-8B layer's 7 projections).
//
// What the design does about that bound:
//   - Forward from the wrapper's row threshold up
//     (ops/int8_matmul.py::_route): the shared wgmma mainloop of
//     qmm_wgmma.cuh as y^T = q^T . x^T with the Int8Fwd policy: q staged by
//     TMA, the pair (k, k + 1) of one column built from two 16-bit shared
//     loads with one byte_perm and converted exactly to bf16x2, straight
//     into register A fragments; the mainloop's epilogue multiplies each f32
//     sum by its column's scale (QmmArgs::col_scale) before the one
//     rounding. The mma.sync split-K kernel took 18.48 ms for one layer's 7
//     projections at M = 8192, 3.5x cuBLAS on a dequantized weight (NVIDIA
//     H100 80GB HBM3, 700 W).
//   - Forward at decode: the pair (k, k + 1) of one column, which one 32-bit
//     B-fragment register of mma.sync m16n8k16 holds, lies N bytes apart in
//     row-major q; the tile is staged in shared memory (16-byte cp.async
//     copies, coalesced rows) and the pairs are built there, so the bf16
//     weight never exists in device memory. A cp.async ring keeps several
//     chunks in flight; thin M splits K over grid.z as the NF4 and int4
//     kernels do, with a deterministic second pass that sums and applies
//     the scale.
//   - Backward: the shared wgmma mainloop of qmm_wgmma.cuh (TMA ring, one
//     producer warp, two consumer warpgroups on a 128 x 256 tile of dx^T,
//     deterministic) with the Int8Dx policy: for fixed k the pair (n, n + 1)
//     is two adjacent bytes of q, the reduction pair an A fragment wants, so
//     one 16-bit shared load and one bf16x2 convert give a register. The
//     scale is applied by a pass over dy before the product (one read and
//     one write of dy, about 0.4 ms of bytes per layer at M = 8192): scaling
//     each staged dy tile inside the mainloop repeats that work for every
//     128-column block of dx (32 to 96 times) and measured slower. The
//     mma.sync design it replaced (64 x 64 tile, 4 warps, a 32-column
//     cp.async ring) took 27.54 ms for one layer's 7 projections at
//     M = 8192, 6.9x cuBLAS on a dequantized weight (NVIDIA H100 80GB HBM3,
//     700 W).
//   - The M, N and K edges are masked (split-K: zero-filled tiles and
//     guarded stores; wgmma: TMA's zero fill and guarded stores).

#include "qmm_wgmma.cuh"
#include "mma_util.cuh"

namespace {

using port::mma_bf16;
using port::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // 4 warps
constexpr int kBK = 64;             // K rows per chunk
constexpr int kBN = 64;             // output columns per block, 16 per warp
constexpr int kQStride = kBN + 16;  // smem bytes per q row (bank spread)
constexpr int kXStride = kBK + 8;   // smem bf16 per x row (bank spread)

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

// dys = bf16(f32(dy) * scale[n]), B9's rounding point, once per element
// before the product. Thread x of the grid owns 8 columns (16 bytes) of
// kScaleRows rows at a time, loads in flight together, and keeps their scales
// in registers. N % 8 == 0.
constexpr int kScaleRows = 4;

__global__ void int8_scale_dy_kernel(const uint4* __restrict__ dy,
                                     const float* __restrict__ scale,
                                     uint4* __restrict__ dys, int M,
                                     int row_chunks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= row_chunks) return;
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale) + 2 * j);
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale) + 2 * j + 1);
  // bf16 -> f32 is a shift, so the only converting instruction is the pack
  const auto mul = [](uint32_t u, float a, float b) {
    return qmm::pack2(__fmul_rn(__uint_as_float(u << 16), a),
                      __fmul_rn(__uint_as_float(u & 0xFFFF0000u), b));
  };
  for (int r0 = blockIdx.y * kScaleRows; r0 < M;
       r0 += gridDim.y * kScaleRows) {
    uint4 v[kScaleRows];
#pragma unroll
    for (int u = 0; u < kScaleRows; ++u) {
      if (r0 + u < M) {
        v[u] = __ldg(dy + static_cast<long>(r0 + u) * row_chunks + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kScaleRows; ++u) {
      if (r0 + u < M) {
        v[u].x = mul(v[u].x, s0.x, s0.y);
        v[u].y = mul(v[u].y, s0.z, s0.w);
        v[u].z = mul(v[u].z, s1.x, s1.y);
        v[u].w = mul(v[u].w, s1.z, s1.w);
        dys[static_cast<long>(r0 + u) * row_chunks + j] = v[u];
      }
    }
  }
}

// B9's decode policy for the quantized-matmul mainloop (qmm_wgmma.cuh),
// as dx^T = q . dys^T. The weight tile is 128 q rows x 64 bytes (TMA,
// 64-byte swizzle, so the 16-bit fragment loads of 8 rows fall in 8
// different bank pairs); fragment row r of warp w in warpgroup wg is q row
// k0 + 64 wg + 16 w + r.
struct Int8Dx : qmm::LinearChunks, qmm::LinearCols {
  static constexpr uint32_t kWBytes = qmm::kTileCols * qmm::kChunk;

  __device__ static uint32_t tx_bytes(const qmm::QmmArgs&) { return kWBytes; }

  __device__ static void load(uint8_t* w, const CUtensorMap* tm_w,
                              const CUtensorMap*, const CUtensorMap*,
                              uint64_t* bar, int i, int k0,
                              const qmm::QmmArgs&) {
    qmm::tma_load_2d(w, tm_w, bar, i * qmm::kChunk, k0);
  }

  __device__ static int col_local(int wg, int warp, int g, int hi) {
    return 64 * wg + 16 * warp + g + 8 * hi;
  }

  // two int8 (the low 16 bits of v) -> bf16x2, exactly: each byte, offset
  // by 128, becomes the low mantissa byte of 2^23, then 2^23 + 128 goes
  static __device__ __forceinline__ uint32_t s8x2(uint32_t v) {
    const uint32_t u = v ^ 0x8080u;
    const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440));
    const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441));
    return qmm::pack2(lo - 8388736.0f, hi - 8388736.0f);
  }

  struct State {
    int row, t;
    __device__ State(const qmm::QmmArgs&, int, int wg, int warp, int g,
                     int t_)
        : row(64 * wg + 16 * warp + g), t(t_) {}

    // bytes (n, n + 1) of one q row are the fragment pair
    __device__ void decode(const uint8_t* w, const float*, int, int ks,
                           uint32_t (&a)[4]) const {
      const int c = 16 * ks + 2 * t;
      const auto ld = [&](int r, int col) {
        return static_cast<uint32_t>(
            *reinterpret_cast<const uint16_t*>(w + qmm::sw64(r, col)));
      };
      a[0] = s8x2(ld(row, c));
      a[1] = s8x2(ld(row + 8, c));
      a[2] = s8x2(ld(row, c + 8));
      a[3] = s8x2(ld(row + 8, c + 8));
    }
  };
};

// B8's decode policy for the same mainloop at prefill and training row
// counts, as y^T = q^T . x^T: A is q^T, its rows the output columns n, its
// reduction k. A stage holds q rows k0 .. k0 + 63 x columns n0 .. n0 + 127
// (TMA, 128-byte swizzle). Fragment rows g and g + 8 of warp w in
// warpgroup wg are the adjacent columns C = 64 wg + 16 w + 2 g and C + 1
// (as Int4Fwd): one 16-bit load of q row k gives both columns at k, one of
// row k + 1 the other half of each pair, and byte_perm pairs them by
// column. The column scale goes on the f32 sum in the epilogue
// (QmmArgs::col_scale), the JAX kernel's rounding point.
struct Int8Fwd : qmm::LinearChunks, qmm::LinearCols {
  static constexpr uint32_t kWBytes = qmm::kChunk * qmm::kTileCols;

  __device__ static uint32_t tx_bytes(const qmm::QmmArgs&) { return kWBytes; }

  __device__ static void load(uint8_t* w, const CUtensorMap* tm_q,
                              const CUtensorMap*, const CUtensorMap*,
                              uint64_t* bar, int i, int n0,
                              const qmm::QmmArgs&) {
    qmm::tma_load_2d(w, tm_q, bar, n0, i * qmm::kChunk);
  }

  __device__ static int col_local(int wg, int warp, int g, int hi) {
    return 64 * wg + 16 * warp + 2 * g + hi;
  }

  struct State {
    int col, t;
    __device__ State(const qmm::QmmArgs&, int, int wg, int warp, int g,
                     int t_)
        : col(64 * wg + 16 * warp + 2 * g), t(t_) {}

    __device__ void decode(const uint8_t* w, const float*, int, int ks,
                           uint32_t (&a)[4]) const {
      const auto ld = [&](int r) {
        return static_cast<uint32_t>(
            *reinterpret_cast<const uint16_t*>(w + qmm::sw128(r, col)));
      };
      const int r = 16 * ks + 2 * t;
      const uint32_t r0 = ld(r), r1 = ld(r + 1), r8 = ld(r + 8),
                     r9 = ld(r + 9);
      a[0] = Int8Dx::s8x2(__byte_perm(r0, r1, 0x0040));  // column C
      a[1] = Int8Dx::s8x2(__byte_perm(r0, r1, 0x0051));  // column C + 1
      a[2] = Int8Dx::s8x2(__byte_perm(r8, r9, 0x0040));
      a[3] = Int8Dx::s8x2(__byte_perm(r8, r9, 0x0051));
    }
  };
};

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

// Forward on the wgmma mainloop (Int8Fwd), on `stream`: the route for
// prefill and training row counts. x: (M, K) bf16, q: (K, N) int8, both
// 16-byte aligned; scale: (N,) f32; out: (M, N) in out_dtype. Requires
// M >= 1, K % 8 == 0 and N % 16 == 0 (the TMA row strides, 2K and N bytes,
// must be 16-byte multiples). Returns the first CUDA error of the
// descriptor encoding and the launch (0 on success).
extern "C" int int8_matmul_wgmma_launch(const void* x, const void* q,
                                        const void* scale, void* out, int M,
                                        int K, int N, int out_dtype,
                                        void* stream) {
  if (M < 1 || K % 8 || N % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_x, tm_q;
  cudaError_t err = qmm::encode_act(&tm_x, x, M, K);
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, N,
                         qmm::kChunk, qmm::kTileCols,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const qmm::QmmArgs args = {out, M, N, K, out_dtype, 0, 0, 0, nullptr, 0,
                             static_cast<const float*>(scale)};
  return static_cast<int>(qmm::launch_qmm<Int8Fwd>(
      tm_x, tm_q, tm_q, tm_q, args, static_cast<cudaStream_t>(stream)));
}

// Backward, on `stream`. dy: (M, N) bf16, 16-byte aligned; q: (K, N) int8;
// scale: (N,) f32, 16-byte aligned, or null when dy is already scaled; dys:
// (M, N) bf16 scratch for the scaled dy when scale is given, else unused;
// dx: (M, K) in out_dtype. Requires M >= 1, N % 16 == 0 (the TMA row
// strides, N and 2N bytes, must be 16-byte multiples). Returns the first
// CUDA error of the launches and the descriptor encoding (0 on success).
extern "C" int int8_matmul_bwd_launch(const void* dy, const void* q,
                                      const void* scale, void* dys, void* dx,
                                      int M, int K, int N, int out_dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scale != nullptr) {
    const int row_chunks = N / 8;
    const int row_groups = (M + kScaleRows - 1) / kScaleRows;
    const dim3 grid((row_chunks + 255) / 256,
                    row_groups < 1024 ? row_groups : 1024);
    int8_scale_dy_kernel<<<grid, 256, 0, s>>>(
        static_cast<const uint4*>(dy), static_cast<const float*>(scale),
        static_cast<uint4*>(dys), M, row_chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dy = dys;
  }
  CUtensorMap tm_dy, tm_q;
  cudaError_t err = qmm::encode_act(&tm_dy, dy, M, N);
  if (err == cudaSuccess) {
    err = qmm::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, N,
                         qmm::kTileCols, qmm::kChunk,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const qmm::QmmArgs args = {dx, M, K, N, out_dtype, 0, 0, 0, nullptr};
  return static_cast<int>(
      qmm::launch_qmm<Int8Dx>(tm_dy, tm_q, tm_q, tm_q, args, s));
}

extern "C" const char* int8_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
