// The shared thin-M streaming kernel of the quantized forwards (sm_90a):
//   y = x @ W,  x (M, K) bf16 with M below the wgmma routes' row threshold
//   (decode and short prefill),  W (K, N) decoded from quantized bytes,
// computed as y^T = W^T . x^T on mma.sync m16n8k16: A is the weight (16
// output columns x 16 k, decoded from the staged bytes into registers), B is
// x^T (16 k x 8 rows of x), so 8 rows of x fill an n8 tile and no
// tensor-core row is padding at M = 8. It stands to the decode route as
// qmm_wgmma.cuh stands to the prefill and training one: the int4 (B6), NF4
// (B1) and int8 (B8) forwards are policies of qmm_thin_kernel.
//
//   - A block owns a slab of kBN = 128 local output columns and one of
//     `splits` runs of K; the splits of one slab are one thread-block
//     cluster.
//   - One producer warp streams the block's run through a ring of stages of
//     kKC = 128 k (the policy's weight bytes, the x tile, and whatever the
//     policy stages beside them, such as group scales) behind full/empty
//     mbarrier pairs: by TMA where the shape allows it, otherwise by plain
//     loads into the same layout. Eight consumer warps decode and multiply
//     without block-wide barriers, so a block keeps several stages in flight
//     while it decodes.
//   - Consumer warp w decodes local columns 32 (w % 4) .. + 31 over k-steps
//     4 (w / 4) .. + 3 of each stage (its k half). Thread (g, t) owns the 4
//     adjacent local columns cl = 32 (w % 4) + 4g .. cl + 3: A tile a takes
//     fragment rows g and g + 8 from local columns cl + 2a and cl + 2a + 1,
//     so a[a][0..1] are the k pair (2t, 2t + 1) of those two columns and
//     a[a][2..3] the pair (2t + 8, 2t + 9).
//   - The reduction stays on chip and in a fixed order: a block adds its two
//     k halves in shared memory and stores each column quad's f32 sums into
//     the receive buffer of the cluster block that owns the quad, through
//     distributed shared memory; after one cluster barrier each block sums
//     its share over the splits in split order, multiplies by the output
//     column's f32 factor where ThinArgs::col_scale is set (the int8 scale,
//     on the whole sum), and writes the output dtype once. One launch, no
//     workspace in device memory, deterministic.
//   - The split count is the one that puts the least work on the busiest SM
//     among those whose clusters are all resident at once (the occupancy
//     API's count of active clusters).
//   - Every stage read by generic loads is handed back to the producer after
//     fence.proxy.async: the next fill may be a TMA (async proxy) write.
//
// A policy supplies the stage's weight layout and its decode:
//
//   struct Policy {
//     static constexpr int kWBytes;          // weight bytes per stage (a
//                                            // multiple of 1024)
//     __host__ __device__ static constexpr int stages(int mt);  // ring
//                                            // depth at 8 mt rows of x
//     __host__ __device__ static constexpr int min_blocks(int mt);
//                                            // __launch_bounds__ blocks
//     __host__ __device__ static int aux_bytes(const ThinArgs&);  // staged
//                                            // bytes beside weight and x
//     __host__ __device__ static int slabs(int N);  // column slabs
//     __device__ static int out_col(int slab, int lc, const ThinArgs&);
//                                            // output column of local
//                                            // column lc, or -1 past N
//     __device__ static void block_init();   // every thread, once, before
//                                            // the block's first barrier
//     __device__ static uint32_t tx_bytes(const ThinArgs&);  // TMA bytes of
//                                            // weight + aux per stage
//     __device__ static void load(uint8_t* w, uint8_t* aux,
//         const CUtensorMap* tm_w, const CUtensorMap* tm_a0,
//         const CUtensorMap* tm_a1, uint64_t* bar, int slab, int k0,
//         const ThinArgs&);                  // TMA path, one thread
//     __device__ static void fill(uint8_t* w, uint8_t* aux, int lane,
//         int slab, int k0, const ThinArgs&);  // plain path, one warp
//     struct State {                         // one per consumer thread
//       __device__ State(const ThinArgs&, int slab, int cl, int kh, int g,
//                        int t);
//       template <bool kFast>
//       __device__ void stage(const uint8_t* aux, int k0, const ThinArgs&);
//       template <bool kFast>
//       __device__ void decode(const uint8_t* w, const uint8_t* aux, int ks,
//                              int k0, const ThinArgs&, uint32_t (&a)[2][4]);
//     };
//   };
//
// A stage is [weight kWBytes][x: two boxes of 8 MT rows x 64 k, 128-byte
// swizzled][aux], rounded up to 1024 bytes (the swizzle's period).
#pragma once

#include "mma_util.cuh"
#include "qmm_wgmma.cuh"


namespace thin {

constexpr int kConsumers = 256;  // 8 warps: 4 column groups x 2 k halves
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kBN = 128;                   // local output columns per block
constexpr int kKC = 128;                   // k per stage
constexpr int kMaxSplits = 8;              // portable cluster size
constexpr int kMaxStages = 6;
constexpr int kMaxSmem = 232448 - 256;     // less the static barriers

struct ThinArgs {
  const __nv_bfloat16* x;   // (M, K) bf16
  const uint8_t* w;         // the weight's bytes
  const void* aux0;         // int4: scales; NF4: absmax_q
  const void* aux1;         // int4: zeros; NF4: absmax_scale
  const float* param;       // NF4: the absmax offset (one f32 on the device)
  const float* col_scale;   // per output column f32 factor on the sum, or
                            // null (int8: its column scale)
  void* out;                // (M, N) in out_dtype (0 f32, 1 bf16, 2 f16)
  int M, K, N, out_dtype;
  int gs, lg_gs;            // int4: group size along K and its log2
  int n_groups;             // int4: group rows; NF4: absmax_scale entries
  int g_rows;               // int4: group rows staged per stage (TMA path)
};

template <int MT>  // n8 tiles of x rows per block: 8 MT rows
struct Geo {
  static constexpr int kRows = 8 * MT;
  // x: two boxes of 64 k (128-byte swizzled rows), one per k half
  static constexpr int kXBytes = 2 * kRows * 128;
  // the receive buffer: every split's sums of this block's share of the
  // slab, kRows rows x at most kBN / 4 / splits + 1 column quads x splits
  static constexpr int kRecvBytes = kRows * (kBN / 4 + kMaxSplits) * 16;
};

// bytes of one stage, a multiple of 1024 (the swizzle's period)
template <class P, int MT>
__host__ __device__ inline int stage_bytes(const ThinArgs& args) {
  return (P::kWBytes + Geo<MT>::kXBytes + P::aux_bytes(args) + 1023) / 1024 *
         1024;
}

// the ring, then the receive buffer (other blocks of the cluster write it
// while this one may still stream), and 1024 for the alignment
template <class P, int MT>
__host__ __device__ inline int smem_bytes(const ThinArgs& args) {
  return P::stages(MT) * stage_bytes<P, MT>(args) + Geo<MT>::kRecvBytes +
         1024;
}

// the first column quad of cluster block `rank`'s share of the slab
__device__ __forceinline__ int quad_lo(int rank, int splits) {
  return rank * (kBN / 4) / splits;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four f32 to `p` in the shared memory of cluster block `rank`
__device__ __forceinline__ void st_dsmem4(float* p, uint32_t rank,
                                          float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(qmm::smem_u32(p)), "r"(rank));
  asm volatile(
      "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
      : "memory");
}

// grid (splits, slabs, M / (8 MT)), cluster (splits, 1, 1). kFast: the
// producer fills stages by TMA; otherwise by plain loads into the same
// layout.
template <class P, int MT, bool kFast>
__global__ void __launch_bounds__(kThreads, P::min_blocks(MT))
qmm_thin_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_a0,
                const __grid_constant__ CUtensorMap tm_a1,
                const ThinArgs args) {
  using Gm = Geo<MT>;
  constexpr int kS = P::stages(MT);
  static_assert(kS >= 2 && kS <= kMaxStages, "ring depth");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  // the 128-byte swizzle repeats every 1024 bytes: stages start there
  uint8_t* smem =
      smem_raw + ((1024 - (qmm::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int splits = gridDim.x;
  const int split = blockIdx.x;  // the block's rank in its cluster
  const int slab = blockIdx.y;
  const int m0 = blockIdx.z * Gm::kRows;
  const int K = args.K;
  const int n_chunks = (K + kKC - 1) / kKC;
  const int c_begin = static_cast<int>(static_cast<long>(split) * n_chunks /
                                       splits);
  const int n_local =
      static_cast<int>(static_cast<long>(split + 1) * n_chunks / splits) -
      c_begin;
  const int st_bytes = stage_bytes<P, MT>(args);

  P::block_init();
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      qmm::mbar_init(&full[s], kFast ? 1 : 32);
      qmm::mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[2][MT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.0f;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cg = warp & 3;   // column group: 32 local columns
  const int kh = warp >> 2;  // k half: k-steps 4 kh .. 4 kh + 3 of a stage
  const int cl = 32 * cg + 4 * g;  // this thread's first local column

  if (warp == kConsumers / 32) {  // producer
    for (int i = 0; i < n_local; ++i) {
      const int s = i % kS;
      if (i >= kS) qmm::mbar_wait(&empty[s], ((i / kS) - 1) & 1);
      uint8_t* st = smem + s * st_bytes;
      uint8_t* sx = st + P::kWBytes;
      uint8_t* sa = sx + Gm::kXBytes;
      const int k0 = (c_begin + i) * kKC;
      if (kFast) {
        if (lane == 0) {
          qmm::mbar_expect_tx(&full[s], P::tx_bytes(args) + Gm::kXBytes);
          P::load(st, sa, &tm_w, &tm_a0, &tm_a1, &full[s], slab, k0, args);
          qmm::tma_load_2d(sx, &tm_x, &full[s], k0, m0);
          qmm::tma_load_2d(sx + Gm::kRows * 128, &tm_x, &full[s], k0 + 64,
                           m0);
        }
      } else {
        P::fill(st, sa, lane, slab, k0, args);
        // x: two boxes of kRows rows x 64 k, as TMA's 128-byte swizzle
        // writes them; zeros past the edges
        auto* sxb = reinterpret_cast<__nv_bfloat16*>(sx);
        for (int e = lane; e < Gm::kRows * kKC; e += 32) {
          const int r = e / kKC;
          const int kk = e % kKC;
          const int box = kk / 64;
          const int row = m0 + r;
          const int k = k0 + kk;
          sxb[(box * Gm::kRows * 128 + qmm::sw128(r, 2 * (kk % 64))) / 2] =
              (row < args.M && k < K)
                  ? args.x[static_cast<long>(row) * K + k]
                  : __float2bfloat16_rn(0.0f);
        }
        qmm::mbar_arrive(&full[s]);  // release: the stores above
      }
    }
  } else {  // consumers
    typename P::State ps(args, slab, cl, kh, g, t);
    // x fragments by ldmatrix: lane l gives the address of row l % 8 of
    // matrix l / 8, the matrices (x tile j, k 0-7), (j, k 8-15), (j + 1,
    // k 0-7), (j + 1, k 8-15) of k-step q in this half's box (128-byte
    // swizzle); register i then holds b0, b1 of tile j, then of tile j + 1
    int xl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      xl[q] = 8 * (lane >> 4) * 128 +
              qmm::sw128(lane & 7, 32 * q + 16 * ((lane >> 3) & 1));
    for (int i = 0; i < n_local; ++i) {
      const int s = i % kS;
      qmm::mbar_wait(&full[s], (i / kS) & 1);
      const uint8_t* sp = smem + s * st_bytes;
      const uint8_t* sx = sp + P::kWBytes + kh * Gm::kRows * 128;
      const uint8_t* sa = sp + P::kWBytes + Gm::kXBytes;
      const int k0 = (c_begin + i) * kKC;
      ps.template stage<kFast>(sa, k0, args);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t a[2][4];
        ps.template decode<kFast>(sp, sa, 4 * kh + q, k0, args, a);
        if (MT == 1) {
          uint32_t b[2];
          port::ldmatrix_x2(b, sx + xl[q]);
          port::mma_bf16(acc[0][0], a[0], b[0], b[1]);
          port::mma_bf16(acc[1][0], a[1], b[0], b[1]);
        } else {
#pragma unroll
          for (int j = 0; j < MT; j += 2) {
            uint32_t b[4];
            port::ldmatrix_x4(b, sx + 8 * j * 128 + xl[q]);
            port::mma_bf16(acc[0][j], a[0], b[0], b[1]);
            port::mma_bf16(acc[1][j], a[1], b[0], b[1]);
            port::mma_bf16(acc[0][j + 1], a[0], b[2], b[3]);
            port::mma_bf16(acc[1][j + 1], a[1], b[2], b[3]);
          }
        }
      }
      // the stage was read by generic loads and its next fill is a TMA
      // (async proxy) write: order the two before handing it back
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      qmm::mbar_arrive(&empty[s]);
    }
    // every consumer is done with the ring: the k-half-1 warps leave their
    // sums there for their k-half-0 partners (the same columns and rows)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    float* xch = reinterpret_cast<float*>(smem) + (tid & 127) * (8 * MT);
    if (kh == 1) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xch[(a * MT + j) * 4 + e] = acc[a][j][e];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (kh == 0) {
      // this thread's quad (local columns cl .. cl + 3: tile a, fragment
      // column e / 2) in rows 8j + 2t + p, half 0 + half 1, pushed to the
      // block that owns the quad, into its slot for this split
      const int qd = cl / 4;
      int owner = 0;
      while (owner + 1 < splits && quad_lo(owner + 1, splits) <= qd) ++owner;
      const int lo = quad_lo(owner, splits);
      const int n_qd = quad_lo(owner + 1, splits) - lo;
      float* recv = reinterpret_cast<float*>(smem + kS * st_bytes);
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // local column cl + i: tile i / 2
            const int e = 2 * (i % 2) + p;
            v[i] = acc[i / 2][j][e] + xch[((i / 2) * MT + j) * 4 + e];
          }
          const int r = 8 * j + 2 * t + p;
          st_dsmem4(recv + ((r * n_qd + qd - lo) * splits + split) * 4,
                    owner, make_float4(v[0], v[1], v[2], v[3]));
        }
    }
  }
  cluster_sync();  // every split's sums are in their owners' buffers

  // this block's share of the slab: column quads qd_lo .. qd_lo + n_qd - 1
  // of every row, summed over the splits in split order (deterministic)
  const float4* recv = reinterpret_cast<const float4*>(smem + kS * st_bytes);
  const int qd_lo = quad_lo(split, splits);
  const int n_qd = quad_lo(split + 1, splits) - qd_lo;
  for (int lq = tid; lq < Gm::kRows * n_qd; lq += kThreads) {
    const int r = lq / n_qd;
    const int c = 4 * (qd_lo + lq % n_qd);
    const int m = m0 + r;
    float4 sum = recv[lq * splits];
    for (int q = 1; q < splits; ++q) {
      const float4 p = recv[lq * splits + q];
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    if (m < args.M) {
      const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = P::out_col(slab, c + e, args);
        if (col < 0) continue;
        const float v = args.col_scale != nullptr
                            ? __fmul_rn(s4[e], args.col_scale[col])
                            : s4[e];
        port::store_out(args.out, static_cast<long>(m) * args.N + col, v,
                        args.out_dtype);
      }
    }
  }
}

// One launch of the MT instantiation. tm_w, tm_a0, tm_a1: the policy's
// tensor maps (read on the TMA path only); `variant` (0 .. kKC) keys the
// cached occupancy readings of instantiations whose shared memory varies
// with the arguments (int4's staged group rows).
template <class P, int MT, bool kFast>
cudaError_t launch_mt(const CUtensorMap& tm_w, const CUtensorMap& tm_a0,
                      const CUtensorMap& tm_a1, const ThinArgs& args,
                      int variant, cudaStream_t stream) {
  using Gm = Geo<MT>;
  const auto kernel = qmm_thin_kernel<P, MT, kFast>;
  const int smem = smem_bytes<P, MT>(args);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap tm_x = {};
  if (kFast) {
    const cudaError_t err = qmm::encode_2d(
        &tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, args.x, args.M, args.K,
        Gm::kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  // splits of K per slab (the cluster size), among those for which every
  // cluster of the grid is resident at once (the occupancy API's count of
  // active clusters at this size and shared memory, queried once per
  // variant) and each split has at least two stages: the one that puts the
  // least work on the busiest SM, ceil(blocks / SMs) blocks of 1 / splits
  // of a slab's run each, over the SMs that clusters of that size can use
  // (active clusters x size / blocks per SM); the larger on a tie
  static int per_sm[kKC + 1];                   // [variant]
  static int active[kKC + 1][kMaxSplits + 1];   // [variant][size]
  if (variant < 0 || variant > kKC) return cudaErrorInvalidValue;
  if (per_sm[variant] == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[variant], kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm[variant] < 1) return cudaErrorInvalidConfiguration;
  }
  const int slabs = P::slabs(args.N);
  const int m_tiles = (args.M + Gm::kRows - 1) / Gm::kRows;
  const int n_chunks = (args.K + kKC - 1) / kKC;
  const long clusters = static_cast<long>(slabs) * m_tiles;
  int splits = 1;
  long best_num = -1;  // the busiest SM's work: best_num / splits runs
  for (int c = 1; c <= kMaxSplits && (c == 1 || n_chunks >= 2 * c); ++c) {
    int& n_active = active[variant][c];
    if (n_active == 0) {
      cudaLaunchConfig_t q = {};
      q.gridDim = dim3(c, 1, 1);
      q.blockDim = dim3(kThreads);
      q.dynamicSmemBytes = smem;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = c;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      q.attrs = at;
      q.numAttrs = 1;
      const cudaError_t err =
          cudaOccupancyMaxActiveClusters(&n_active, kernel, &q);
      if (err != cudaSuccess) return err;
      if (n_active == 0) n_active = -1;  // not resident at this size
    }
    if (n_active < 1 || clusters > n_active) continue;
    long sms = static_cast<long>(n_active) * c / per_sm[variant];
    if (sms < 1) sms = 1;
    const long num = (clusters * c + sms - 1) / sms;
    if (best_num < 0 || num * splits <= best_num * c) {
      splits = c;
      best_num = num;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, slabs, m_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_w, tm_a0, tm_a1, args);
}

// The instantiation for args.M rows (8, 16, 32, 64 or 128 rows of x per
// block), on the TMA path if `fast`; returns the first CUDA error of the
// descriptor encoding and the launch (0 on success).
template <class P, bool kFast>
cudaError_t launch_rows(const CUtensorMap& tm_w, const CUtensorMap& tm_a0,
                        const CUtensorMap& tm_a1, const ThinArgs& args,
                        int variant, cudaStream_t s) {
  if (args.M <= 8) return launch_mt<P, 1, kFast>(tm_w, tm_a0, tm_a1, args,
                                                 variant, s);
  if (args.M <= 16) return launch_mt<P, 2, kFast>(tm_w, tm_a0, tm_a1, args,
                                                  variant, s);
  if (args.M <= 32) return launch_mt<P, 4, kFast>(tm_w, tm_a0, tm_a1, args,
                                                  variant, s);
  if (args.M <= 64) return launch_mt<P, 8, kFast>(tm_w, tm_a0, tm_a1, args,
                                                  variant, s);
  return launch_mt<P, 16, kFast>(tm_w, tm_a0, tm_a1, args, variant, s);
}

template <class P>
cudaError_t launch(const CUtensorMap& tm_w, const CUtensorMap& tm_a0,
                   const CUtensorMap& tm_a1, const ThinArgs& args, bool fast,
                   int variant, cudaStream_t s) {
  const cudaError_t err =
      fast ? launch_rows<P, true>(tm_w, tm_a0, tm_a1, args, variant, s)
           : launch_rows<P, false>(tm_w, tm_a0, tm_a1, args, variant, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace thin
