// W8A16 int8 matmul for Hopper (sm_90a), forward and backward:
//   y  = (x @ q) * scale[n]              (qmm_wgmma_kernel<Int8Fwd> at
//                                         prefill and training row counts;
//                                         qmm_thin_kernel<Int8Thin> of
//                                         qmm_thin.cuh at decode and short
//                                         prefill)
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
//     the scale multiplies the f32 sum once per output element after the
//     whole K reduction (on the thin route after the cluster's split
//     reduce, never on a split), then one rounding to the caller's dtype.
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
//   - Forward below the threshold: the thin-M streaming kernel of
//     qmm_thin.cuh with the Int8Thin policy (below), shared with the NF4 and
//     int4 forwards: a producer warp streams 16 KB stages of q (128 k x 128
//     columns) by TMA, eight consumer warps build each thread's 4 columns'
//     k pairs from two 32-bit shared loads and one byte_perm per column into
//     mma.sync A fragments (the weight is the A operand, so 8 rows of x fill
//     an n8 tile), and the K splits of a column slab are summed in a
//     thread-block cluster through distributed shared memory before the
//     scale: one launch, no workspace, deterministic. The split-K kernel it
//     replaced (16-row x tiles, f32 partials in device memory summed and
//     scaled by a second launch) took 0.1314 ms of device time for one
//     layer's 7 projections at M = 8 (NVIDIA H100 80GB HBM3, 700 W).
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
//   - The M, N and K edges are masked (TMA's zero fill, or zeros written by
//     the thin kernel's producer warp, and guarded stores).

#include "mma_util.cuh"
#include "qmm_thin.cuh"
#include "qmm_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// B8's policy for the thin-M kernel of qmm_thin.cuh (decode and short
// prefill row counts). A stage holds q rows k0 .. k0 + 127 x columns n0 ..
// n0 + 127 (16 KB: TMA with the 128-byte swizzle where K % 8 and N % 16 are
// zero, otherwise plain loads into the same layout, zeros past K and N).
// Thread (g, t) owns the adjacent columns cl .. cl + 3: one 32-bit load of q
// row k gives the 4 columns at k, one of row k + 1 the other half of each
// pair, and one byte_perm per column pairs them for Int8Dx::s8x2's exact
// bf16x2. The column scale goes on the f32 sum after the cluster reduce
// (ThinArgs::col_scale), the JAX kernel's rounding point, never on a split.
struct Int8Thin {
  static constexpr int kWBytes = thin::kKC * thin::kBN;

  // 16 KB of q a stage: fewer stages fit than for the 4-bit formats. Up to
  // 32 rows of x two blocks share an SM (3-5 stages each); from 64 rows one
  // block holds the SM and takes what the receive buffer leaves
  __host__ __device__ static constexpr int stages(int mt) {
    return mt <= 1 ? 5 : mt <= 2 ? 4 : mt <= 4 ? 3 : mt <= 8 ? 4 : 3;
  }
  __host__ __device__ static constexpr int min_blocks(int mt) {
    return mt <= 4 ? 2 : 1;
  }
  __host__ __device__ static int aux_bytes(const thin::ThinArgs&) {
    return 0;
  }
  __host__ __device__ static int slabs(int n) {
    return (n + thin::kBN - 1) / thin::kBN;
  }
  __device__ static int out_col(int slab, int lc, const thin::ThinArgs& args) {
    const int col = slab * thin::kBN + lc;
    return col < args.N ? col : -1;
  }
  __device__ static void block_init() {}

  __device__ static uint32_t tx_bytes(const thin::ThinArgs&) {
    return kWBytes;
  }

  __device__ static void load(uint8_t* w, uint8_t*, const CUtensorMap* tm_q,
                              const CUtensorMap*, const CUtensorMap*,
                              uint64_t* bar, int slab, int k0,
                              const thin::ThinArgs&) {
    qmm::tma_load_2d(w, tm_q, bar, slab * thin::kBN, k0);
  }

  __device__ static void fill(uint8_t* w, uint8_t*, int lane, int slab,
                              int k0, const thin::ThinArgs& args) {
    const int n0 = slab * thin::kBN;
    for (int e = lane; e < kWBytes; e += 32) {
      const int r = e / thin::kBN;
      const int c = e % thin::kBN;
      const int row = k0 + r;
      w[qmm::sw128(r, c)] =
          (row < args.K && n0 + c < args.N)
              ? args.w[static_cast<long>(row) * args.N + n0 + c]
              : 0;
    }
  }

  struct State {
    int o0, o1, o8, o9;  // the thread's words in rows 2t, 2t + 1, 2t + 8,
                         // 2t + 9 of a k-step (the swizzle repeats every 8)

    __device__ State(const thin::ThinArgs&, int, int cl, int, int, int t)
        : o0(qmm::sw128(2 * t, cl)),
          o1(qmm::sw128(2 * t + 1, cl)),
          o8(qmm::sw128(2 * t + 8, cl)),
          o9(qmm::sw128(2 * t + 9, cl)) {}

    template <bool kFast>
    __device__ void stage(const uint8_t*, int, const thin::ThinArgs&) {}

    template <bool kFast>
    __device__ void decode(const uint8_t* w, const uint8_t*, int ks, int,
                           const thin::ThinArgs&, uint32_t (&a)[2][4]) const {
      const uint8_t* rows = w + 16 * ks * thin::kBN;
      const auto ld = [&](int o) {
        return *reinterpret_cast<const uint32_t*>(rows + o);
      };
      const uint32_t w0 = ld(o0), w1 = ld(o1), w8 = ld(o8), w9 = ld(o9);
#pragma unroll
      for (int ta = 0; ta < 2; ++ta) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * ta + e;
          const uint32_t sel = ((4 + col) << 4) | col;  // (k, k + 1) bytes
          a[ta][e] = Int8Dx::s8x2(__byte_perm(w0, w1, sel));
          a[ta][2 + e] = Int8Dx::s8x2(__byte_perm(w8, w9, sel));
        }
      }
    }
  };
};

}  // namespace

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

// Forward on the thin-M kernel (qmm_thin_kernel<Int8Thin>), on `stream`:
// the route for decode and short prefill row counts. x: (M, K) bf16, q:
// (K, N) int8, both 16-byte aligned; scale: (N,) f32; out: (M, N) in
// out_dtype. Requires M >= 1; any K and N (the TMA path takes K % 8 == 0 and
// N % 16 == 0, the plain-load path the rest). One launch (a cluster per
// column slab), no workspace. Returns the first CUDA error of the
// descriptor encoding and the launch (0 on success).
extern "C" int int8_matmul_thin_launch(const void* x, const void* q,
                                       const void* scale, void* out, int M,
                                       int K, int N, int out_dtype,
                                       void* stream) {
  if (M < 1 || K < 1 || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool fast = K % 8 == 0 && N % 16 == 0;
  thin::ThinArgs args = {};
  args.x = static_cast<const bf16*>(x);
  args.w = static_cast<const uint8_t*>(q);
  args.col_scale = static_cast<const float*>(scale);
  args.out = out;
  args.M = M;
  args.K = K;
  args.N = N;
  args.out_dtype = out_dtype;
  CUtensorMap tm_q = {};
  if (fast) {
    const cudaError_t err =
        qmm::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, N,
                       thin::kKC, thin::kBN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(thin::launch<Int8Thin>(
      tm_q, tm_q, tm_q, args, fast, 0, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* int8_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
