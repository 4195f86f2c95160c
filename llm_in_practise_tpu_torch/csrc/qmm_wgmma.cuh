// The shared Hopper mainloop of the quantized matmuls (sm_90a): a product
// whose A operand is a quantized weight and whose B operand is a bf16
// activation,
//   out^T = A . act^T,  act (M, red) bf16,  A (cols, red) decoded from
//   quantized bytes,  out (M, cols),
// one (kTileCols x kBM) tile of out^T per block, reducing over all of `red`
// inside the block in a fixed order (no atomics, no split of the reduction:
// deterministic). Both directions of a quantized linear layer have this
// shape:
//   - dx = dy @ W^T, W (K, N): dx^T = W . dy^T. A is W (rows k, the output
//     columns; reduction n), the activation is dy; cols = K, red = N.
//   - y = x @ W: y^T = W^T . x^T. A is W^T (rows n, the output columns;
//     reduction k), the activation is x; cols = N, red = K.
//
//   - A operand (64 x 16 per consumer warpgroup, from registers: the RS form
//     of wgmma.mma_async): the weight tile. The consumer threads decode it
//     straight from the raw bytes staged in shared memory into A fragments.
//     No bf16 copy of the weight exists in device or shared memory.
//   - B operand (from shared memory): the activation, kChunk = 64 reduction
//     columns per stage (128 bytes of bf16 per row), in the 128-byte-swizzled
//     layout that TMA writes and the wgmma descriptor reads.
//   - One producer thread keeps a ring of up to kMaxStages stages (as deep
//     as shared memory allows) full with TMA (cp.async.bulk.tensor) behind
//     full/empty mbarrier pairs; two consumer warpgroups (setmaxnreg gives
//     them the registers) each own 64 rows of out^T (64 output columns) x
//     kBM output rows, with f32 accumulators. Stage i's decode overlaps
//     stage i-1's products (wgmma.wait_group 1).
//   - TMA's out-of-bounds zero fill masks the M and reduction edges of the
//     activation and the edges of the staged weight bytes; the epilogue
//     stages the tile through shared memory and writes the output row-major
//     (16-byte stores where the row allows), rounded once to the caller's
//     dtype.
//
// A decode policy says which reduction columns each stage holds and turns
// the staged raw bytes (and whatever else it stages in the same ring, such
// as group scales and zeros) into A fragments:
//
//   struct Policy {
//     static constexpr uint32_t kWBytes;  // staged weight bytes per stage
//     __device__ static uint32_t tx_bytes(const QmmArgs&);  // TMA bytes of
//                                         // weight + aux per stage
//     __device__ static int n_chunks(const QmmArgs&);  // stages of one
//                                         // block's reduction
//     __device__ static int act_col(int i, const QmmArgs&);  // first
//                                         // activation column of stage i
//     __device__ static void load(uint8_t* w, const CUtensorMap* tm_w,
//                                 const CUtensorMap* tm_aux0,
//                                 const CUtensorMap* tm_aux1, uint64_t* bar,
//                                 int i, int c0, const QmmArgs&);
//     __device__ static int col_local(int wg, int warp, int g, int hi);
//     __device__ static int out_col(int block_x, int cc, const QmmArgs&);
//                                         // the output column of tile
//                                         // column cc, or -1 past the edge
//     struct State {  // one per consumer thread
//       __device__ State(const QmmArgs&, int c0, int wg, int warp, int g,
//                        int t);
//       __device__ void decode(const uint8_t* w, const float* aux, int i,
//                              int ks, uint32_t (&a)[4]) const;
//     };
//   };
//
// c0 is the block's first output column, i the stage's index in the
// reduction (a policy may walk the reduction in any order: the NF4 dx policy
// takes the high-nibble half of N, then the low one); LinearChunks is the
// plain order, act_col(i) = i * kChunk. out_col places the tile's columns in
// the output (the NF4 forward's tile is two ranges of 64, one in each half of
// N); it maps each run of 8 tile columns from a multiple of 8 to contiguous
// output columns (or to -1 from some column of the run on), and LinearCols
// is the plain map, c0 + cc below cols. Where QmmArgs::col_scale is set, the
// epilogue multiplies each f32 sum by its output column's factor before the
// one rounding to the output dtype (the int8 forward's per-column scale).
//
// Fragment layouts (PTX ISA, wgmma .m64nNk16 .bf16), g = lane / 4,
// t = lane % 4, warp w of the warpgroup holding rows 16w .. 16w + 15:
//   A (registers): a[0] = A[16w+g][2t..2t+1],   a[1] = A[16w+g+8][2t..2t+1],
//                  a[2] = A[16w+g][2t+8..2t+9], a[3] = A[16w+g+8][2t+8..2t+9]
//   D (f32, N = 128): d[4j + e] = D[16w + g + 8(e/2)][8j + 2t + e%2]
// col_local maps (warpgroup, warp, g, e/2) to the output column of an A row,
// so a policy may permute the rows (int4 maps rows g and g+8 to the two
// nibbles of one packed byte, or to two adjacent columns) and the epilogue
// undoes it.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached
                   // through the runtime (cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace qmm {

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kTileCols = 128;              // output columns per block
constexpr int kNB = 2;                      // 128-row halves of the rows
constexpr int kBM = 128 * kNB;              // output rows per block
constexpr int kChunk = 64;                  // reduction columns per stage
constexpr int kMaxStages = 4;
constexpr int kOutStride = kTileCols + 4;   // f32 per staged output row
constexpr uint32_t kActBytes = kBM * kChunk * 2;

struct QmmArgs {
  void* out;           // (M, cols) in out_dtype (0 f32, 1 bf16, 2 f16)
  int M;               // rows of the activation and of the output
  int cols;            // output columns, the rows of A (dx: K, forward: N)
  int red;             // reduction length (dx: N, forward: K)
  int out_dtype;
  int gs;              // int4: group size along K
  int g_rows;          // int4: group rows staged per stage
  int aux_bytes;       // staged bytes per stage besides the activation and
                       // the weight
  const float* param;  // NF4: the absmax offset (one f32 on the device)
  int stages;          // ring depth, 2 .. kMaxStages (set by launch_qmm)
  const float* col_scale;  // per output column f32 factor on the sum, or
                           // null (int8 forward: its column scale)
};

// the plain walk over the reduction: stage i holds columns i * kChunk ..
struct LinearChunks {
  __device__ static int n_chunks(const QmmArgs& args) {
    return (args.red + kChunk - 1) / kChunk;
  }
  __device__ static int act_col(int i, const QmmArgs&) { return i * kChunk; }
};

// the plain map of tile columns to output columns: c0 + cc, up to cols
struct LinearCols {
  __device__ static int out_col(int block_x, int cc, const QmmArgs& args) {
    const int col = block_x * kTileCols + cc;
    return col < args.cols ? col : -1;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// box at (column c0, row c1) of a 2-D tensor map into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// box at element c0 of a 1-D tensor map into shared memory
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// 128-byte-swizzled K-major operand: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |   // LBO (unused when swizzled)
         (static_cast<uint64_t>(64) << 32) |  // SBO: 1024 bytes
         (static_cast<uint64_t>(1) << 62);    // 128-byte swizzle
}

// d (64 x 128, f32) += a (64 x 16, bf16, registers) . b (16 x 128, bf16,
// shared memory at desc_b)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// two f32 -> one register of two bf16 (round to nearest even); `lo` is the
// smaller index of the fragment pair
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of (row, col) in a tile of 64-byte rows written by TMA with
// CU_TENSOR_MAP_SWIZZLE_64B: 16-byte chunk bits 4-5 ^= address bits 7-8
__device__ __forceinline__ int sw64(int row, int col) {
  return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// byte offset of (row, col) in a tile of 128-byte rows written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk bits 4-6 ^= address bits 7-9
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

template <class Policy>
__host__ __device__ constexpr uint32_t stage_bytes(int aux_bytes) {
  return kActBytes + Policy::kWBytes + aux_bytes;
}

template <class Policy>
__global__ void __launch_bounds__(kThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_act,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_aux0,
                 const __grid_constant__ CUtensorMap tm_aux1,
                 const QmmArgs args) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  // the 128-byte swizzle repeats every 1024 bytes: stages start there
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t st_bytes = stage_bytes<Policy>(args.aux_bytes);
  const int c0 = blockIdx.x * kTileCols;
  const int m0 = blockIdx.y * kBM;
  const int n_chunks = Policy::n_chunks(args);
  const int n_st = args.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {  // one thread issues every copy
      const uint32_t tx = kActBytes + Policy::tx_bytes(args);
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % n_st;
        if (i >= n_st) mbar_wait(&empty[s], ((i / n_st) - 1) & 1);
        uint8_t* st = smem + s * st_bytes;
        mbar_expect_tx(&full[s], tx);
        tma_load_2d(st, &tm_act, &full[s], Policy::act_col(i, args), m0);
        Policy::load(st + kActBytes, &tm_w, &tm_aux0, &tm_aux1, &full[s], i,
                     c0, args);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const typename Policy::State ps(args, c0, wg, warp, g, t);

    float acc[kNB][64];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[nb][r] = 0.0f;
    // A fragments, double-buffered: stage i decodes into a[i % 2] while
    // stage i - 1's products may still read a[(i - 1) % 2]
    uint32_t a[2][4][4] = {};

    const auto step = [&](int i, auto parity) {
      constexpr int P = decltype(parity)::value;
      const int s = i % n_st;
      mbar_wait(&full[s], (i / n_st) & 1);
      const uint8_t* st = smem + s * st_bytes;
      const float* aux =
          reinterpret_cast<const float*>(st + kActBytes + Policy::kWBytes);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        ps.decode(st + kActBytes, aux, i, ks, a[P][ks]);
      }
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int r = 0; r < 64; ++r) fence_operand(acc[nb][r]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint64_t desc = desc_sw128(smem_u32(st));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
          // +32 bytes per k16 step inside the swizzle atom, +16 KB per
          // 128 activation rows
          wgmma_m64n128k16_rs(acc[nb], a[P][ks],
                              desc + ((nb * 16384 + ks * 32) >> 4));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      // stage i - 1 is done: its A registers are free from here on, its
      // stage goes back to the producer
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_operand(a[1 - P][ks][r]);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int r = 0; r < 64; ++r) fence_operand(acc[nb][r]);
      if (i > 0) {
        // stage i - 1 was read by generic loads (the decode) and its next
        // fill is a TMA (async proxy) write: order the two before handing
        // it back
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&empty[(i - 1) % n_st]);
      }
    };
    for (int i = 0; i < n_chunks; i += 2) {
      step(i, std::integral_constant<int, 0>());
      if (i + 1 < n_chunks) step(i + 1, std::integral_constant<int, 1>());
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 64; ++r) fence_operand(acc[nb][r]);

    // epilogue: out^T from the accumulators into a row-major f32 tile in
    // shared memory (the ring is free once both warpgroups are here)
    consumer_sync();
    float* so = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = nb * 128 + 8 * j + 2 * t + (e & 1);
          so[m * kOutStride + Policy::col_local(wg, warp, g, e >> 1)] =
              acc[nb][4 * j + e];
        }
    consumer_sync();
    // 8 output columns per thread and step; 16-byte stores where the row
    // allows
    const int C = args.cols;
    const bool vec = (C % 8) == 0;
    for (int c = tid; c < kBM * (kTileCols / 8); c += kConsumers) {
      const int r = c / (kTileCols / 8);
      const int cc = (c % (kTileCols / 8)) * 8;
      const int m = m0 + r;
      const int col = Policy::out_col(blockIdx.x, cc, args);
      if (m >= args.M || col < 0) continue;
      // the run's live columns: all 8 where the map keeps them in the output
      const bool whole = Policy::out_col(blockIdx.x, cc + 7, args) == col + 7;
      const float* src = so + r * kOutStride + cc;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      if (args.col_scale != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ce = whole ? col + e : Policy::out_col(blockIdx.x, cc + e,
                                                           args);
          if (ce >= 0) v[e] = __fmul_rn(v[e], args.col_scale[ce]);
        }
      }
      const long o = static_cast<long>(m) * C + col;
      if (vec && whole && (col % 8) == 0) {
        if (args.out_dtype == 0) {
          auto* p =
              reinterpret_cast<float4*>(static_cast<float*>(args.out) + o);
          p[0] = make_float4(v[0], v[1], v[2], v[3]);
          p[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else if (args.out_dtype == 1) {
          uint4 u = {pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                     pack2(v[6], v[7])};
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(args.out) +
                                    o) = u;
        } else {
          uint4 u;
          __half2 h[4] = {__floats2half2_rn(v[0], v[1]),
                          __floats2half2_rn(v[2], v[3]),
                          __floats2half2_rn(v[4], v[5]),
                          __floats2half2_rn(v[6], v[7])};
          u.x = *reinterpret_cast<uint32_t*>(&h[0]);
          u.y = *reinterpret_cast<uint32_t*>(&h[1]);
          u.z = *reinterpret_cast<uint32_t*>(&h[2]);
          u.w = *reinterpret_cast<uint32_t*>(&h[3]);
          *reinterpret_cast<uint4*>(static_cast<__half*>(args.out) + o) = u;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ce = Policy::out_col(blockIdx.x, cc + e, args);
          if (ce < 0) break;
          const long oe = static_cast<long>(m) * C + ce;
          if (args.out_dtype == 1) {
            static_cast<__nv_bfloat16*>(args.out)[oe] =
                __float2bfloat16_rn(v[e]);
          } else if (args.out_dtype == 2) {
            static_cast<__half*>(args.out)[oe] = __float2half_rn(v[e]);
          } else {
            static_cast<float*>(args.out)[oe] = v[e];
          }
        }
      }
    }
  }
}

// ---- host side ----

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so nothing links libcuda
inline cudaError_t encode_tiled_fn(EncodeTiledFn* out) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiledFn>(fn);
  }
  *out = cached;
  return cudaSuccess;
}

// a row-major (rows, cols) tensor of `elem`-byte elements, copied in boxes
// of (box_rows, box_cols); out-of-bounds elements read as zeros
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                             int elem, const void* base, long rows, long cols,
                             int box_rows, int box_cols,
                             CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn;
  const cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a vector of `len` f32 copied in boxes of `box` elements (box * 4 a
// multiple of 16) from 16-byte-aligned starts (a box at another start
// faults); out-of-bounds elements read as zeros
inline cudaError_t encode_1d_f32(CUtensorMap* map, const void* base, long len,
                                 int box) {
  EncodeTiledFn fn;
  const cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(len)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(len) * 4};  // unread
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<void*>(base), dims, strides, boxes, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the activation (M, red) bf16 in boxes of (kBM rows, kChunk columns),
// 128-byte swizzle
inline cudaError_t encode_act(CUtensorMap* map, const void* act, int M,
                              int red) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, act, M, red,
                   kBM, kChunk, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the ring as deep as shared memory allows, up to kMaxStages
template <class Policy>
inline cudaError_t launch_qmm(const CUtensorMap& tm_act,
                              const CUtensorMap& tm_w,
                              const CUtensorMap& tm_aux0,
                              const CUtensorMap& tm_aux1, QmmArgs args,
                              cudaStream_t stream) {
  constexpr size_t kSmem = 232448 - 1024 - 256;  // less alignment, barriers
  const size_t stage = stage_bytes<Policy>(args.aux_bytes);
  const size_t out = static_cast<size_t>(kBM) * kOutStride * 4;
  args.stages = static_cast<int>(kSmem / stage);
  if (args.stages > kMaxStages) args.stages = kMaxStages;
  if (args.stages < 2 || out > kSmem) return cudaErrorInvalidConfiguration;
  const size_t ring = args.stages * stage;
  const size_t smem = (ring > out ? ring : out) + 1024;  // + alignment
  const auto kernel = qmm_wgmma_kernel<Policy>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((args.cols + kTileCols - 1) / kTileCols,
                  (args.M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(tm_act, tm_w, tm_aux0, tm_aux1,
                                           args);
  return cudaGetLastError();
}

}  // namespace qmm
