// Causal flash attention for Hopper (sm_90a): forward, dK/dV and dQ.
//
// Replaces the TPU kernels of llm_in_practise_tpu/ops/flash_attention.py:
//   - flash_fwd_kernel     <- _fwd_kernel      (pallas_call in _flash_fwd_call)
//   - flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (first pallas_call in
//                                               _flash_bwd_call)
//   - flash_bwd_dq_kernel  <- _bwd_dq_kernel   (second pallas_call there)
// They compute the same functions: O = softmax(scale * Q K^T + causal) V with
// the per-row log-sum-exp LSE (natural log, f32), and the FlashAttention-2
// backward from the saved LSE with delta = rowsum(dO * O) computed by the
// caller: P = exp(scale * Q K^T - LSE), dV = P^T dO, dP = dO V^T,
// dS = P * (dP - delta), dQ = scale * dS K, dK = scale * dS^T Q.
//
// Layout: q, k, v, dO are (B, L, heads, D) read through the strides the
// caller passes (elements; D is contiguous), so no moveaxis copy is made.
// GQA is native: query head h reads KV head h / (H / Hkv); K and V are never
// repeated in memory. Outputs O, dQ, dK, dV are written contiguous
// (B, L, heads, D) in bf16; LSE is (B, H, L) f32. The ragged edge (L not a
// multiple of the 64-row tile) is masked, not padded.
//
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the training
// shapes (B 8, L 1024, H 32, Hkv 8, D 128) all three are bound by tensor-core
// operations on the live (causal) half of the score matrix: 2 products in the
// forward (QK^T, PV), 4 in dK/dV (QK^T, P^T dO, dO V^T, dS^T Q) and 3 in dQ
// (QK^T, dO V^T, dS K).
//
// What the design does about that bound:
//   - Every product runs on bf16 mma.sync m16n8k16 with f32 accumulators;
//     softmax statistics stay in f32 (exp2 with the scale folded in).
//   - Causally dead tiles are never visited: a query tile loops over key
//     tiles up to the diagonal, a key tile over query tiles from it on; only
//     the diagonal and ragged tiles pay for the mask.
//   - P and dS go from accumulator registers straight into A fragments; K,
//     V, Q and dO tiles are double-buffered through cp.async; V, K, dO and Q
//     in the "transposed" operand role come through ldmatrix.trans.
//   - dK/dV: one block per (batch, KV head, 64-key tile) loops over the G
//     query heads of its group and every live query tile, summing dK and dV
//     in registers: no atomics, deterministic. dQ: one block per (batch,
//     query head, 64-row tile): also no atomics.
//   - Query tiles are scheduled longest first (the diagonal makes later
//     tiles longer), to shorten the tail of the grid.
// wgmma and TMA are left for a later version.

#include "mma_util.cuh"

namespace {

using port::ld_u32;
using port::mma_bf16;
using port::pack_bf16;

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Geo {
  static constexpr int kStride = D + 8;               // bf16 per smem row
  static constexpr int kTileElems = kTile * kStride;  // one 64-row tile
};

// Copy rows [r0, r0 + 64) of one head of a (B, L, heads, D) tensor into a
// [64][D + 8] smem tile; rows at or past L are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long s_l, int r0, int L, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte copies per row
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int row = r0 + r;
    const __nv_bfloat16* src =
        base + static_cast<long>(row < L ? row : L - 1) * s_l + c * 8;
    port::cp_async16(dst + r * Geo<D>::kStride + c * 8, src,
                     row < L ? 16 : 0);
  }
}

// C[16 x 64] += A[16 rows of a_tile] * B^T where B is a [64][D] smem tile
// used as the (k = d, n = row of b_tile) operand: S = Q K^T, dP = dO V^T.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4],
                                        const __nv_bfloat16* a_tile,
                                        int a_row0,
                                        const __nv_bfloat16* b_tile, int g,
                                        int t) {
  constexpr int S = Geo<D>::kStride;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* ap = a_tile + (a_row0 + g) * S + kk * 16 + 2 * t;
    uint32_t a[4];
    a[0] = ld_u32(ap);
    a[1] = ld_u32(ap + 8 * S);
    a[2] = ld_u32(ap + 8);
    a[3] = ld_u32(ap + 8 * S + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* bp = b_tile + (nt * 8 + g) * S + kk * 16 + 2 * t;
      mma_bf16(c[nt], a, ld_u32(bp), ld_u32(bp + 8));
    }
  }
}

// acc[16 x D] += P[16 x 64] * V where P is held as 8 f32 C tiles and V is a
// [64][D] smem tile used as the (k = row, n = d) operand through
// ldmatrix.trans: O += P V, dV += P^T dO, dQ += dS K, dK += dS^T Q.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const float (&p)[8][4],
                                       const __nv_bfloat16* v_tile,
                                       int lane) {
  constexpr int S = Geo<D>::kStride;
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* row =
        v_tile + (kk * 16 + (lane & 7) + (mi & 1) * 8) * S + (mi >> 1) * 8;
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b[4];
      port::ldmatrix_x4_trans(b, row + dt * 8);
      mma_bf16(acc[dt], a, b[0], b[1]);
      mma_bf16(acc[dt + 1], a, b[2], b[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
}

__device__ __forceinline__ void zero8(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
}

// Store a warp's 16 x D accumulator rows [row0, row0 + 16) (times `mul`) as
// bf16 into a contiguous (.., D) head slice with row stride `s_l`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long s_l,
                                           int row0, int L,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, int g,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + half * 8;
    if (row >= L) continue;
    const float mul = half ? mul1 : mul0;
    __nv_bfloat16* dst = base + static_cast<long>(row) * s_l + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * half] * mul, acc[dt][2 * half + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------- forward
// grid (n_qtiles, H, B); smem: Q tile, K and V double-buffered.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int L, int H, int Hkv, long q_sb, long q_sl, long q_sh,
                 long k_sb, long k_sl, long k_sh, long v_sb, long v_sl,
                 long v_sh, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = Geo<D>::kTileElems;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + T;      // 2 buffers
  __nv_bfloat16* sV = sK + 2 * T;  // 2 buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // longest (latest) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kTile;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  load_tile<D>(sQ, qb, q_sl, q0, L, tid);
  load_tile<D>(sK, kb, k_sl, 0, L, tid);
  load_tile<D>(sV, vb, v_sl, 0, L, tid);
  port::cp_async_commit();

  float acc[D / 8][4];
  zero_acc<D>(acc);
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.0f, 0.0f};
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, +8

  const int n_kt = qt + 1;  // key tiles up to the diagonal
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      const int nb = (j + 1) & 1;
      load_tile<D>(sK + nb * T, kb, k_sl, (j + 1) * kTile, L, tid);
      load_tile<D>(sV + nb * T, vb, v_sl, (j + 1) * kTile, L, tid);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + (j & 1) * T;
    const __nv_bfloat16* tV = sV + (j & 1) * T;
    const int k0 = j * kTile;

    float s[8][4];
    zero8(s);
    mma_abt<D>(s, sQ, warp * 16, tK, g, t);

    const bool edge = (j == qt) || (k0 + kTile > L);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = row_a + (e >= 2 ? 8 : 0);
          if (key > row || key >= L) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }
    // online softmax over this tile (rows row_a and row_a + 8)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // key 0 is live for every row, so m is finite from the first tile on
      const float m_new = fmaxf(m_row[hr], mx);
      const float alpha = exp2f(m_row[hr] - m_new);
      m_row[hr] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = exp2f(s[nt][2 * hr] - m_new);
        const float p1 = exp2f(s[nt][2 * hr + 1] - m_new);
        s[nt][2 * hr] = p0;
        s[nt][2 * hr + 1] = p1;
        sum += p0 + p1;
      }
      l_row[hr] = l_row[hr] * alpha + sum;  // this thread's partial sum
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * hr] *= alpha;
        acc[dt][2 * hr + 1] *= alpha;
      }
    }
    mma_pv<D>(acc, s, tV, lane);
    __syncthreads();  // the next iteration refills this buffer
  }

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_row[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hr] = 1.0f / l;
    const int row = row_a + hr * 8;
    if (t == 0 && row < L) {
      lse[(static_cast<long>(b) * H + h) * L + row] =
          (m_row[hr] + log2f(l)) * kLn2;
    }
  }
  const long o_sl = static_cast<long>(H) * D;
  __nv_bfloat16* ob = o + static_cast<long>(b) * L * o_sl + h * D;
  store_rows<D>(ob, o_sl, q0 + warp * 16, L, acc, inv[0], inv[1], g, t);
}

// ------------------------------------------------------------------ dQ
// grid (n_qtiles, H, B); smem: Q and dO tiles, K and V double-buffered.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int L, int H, int Hkv,
                    long q_sb, long q_sl, long q_sh, long k_sb, long k_sl,
                    long k_sh, long v_sb, long v_sl, long v_sh, long d_sb,
                    long d_sl, long d_sh, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = Geo<D>::kTileElems;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + T;
  __nv_bfloat16* sK = sdO + T;     // 2 buffers
  __nv_bfloat16* sV = sK + 2 * T;  // 2 buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kTile;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* db = dout + b * d_sb + h * d_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  load_tile<D>(sQ, qb, q_sl, q0, L, tid);
  load_tile<D>(sdO, db, d_sl, q0, L, tid);
  load_tile<D>(sK, kb, k_sl, 0, L, tid);
  load_tile<D>(sV, vb, v_sl, 0, L, tid);
  port::cp_async_commit();

  const int row_a = q0 + warp * 16 + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_a + hr * 8;
    const long i = (static_cast<long>(b) * H + h) * L + row;
    lse2[hr] = row < L ? lse[i] * kLog2e : 0.0f;
    dlt[hr] = row < L ? delta[i] : 0.0f;
  }

  float acc[D / 8][4];
  zero_acc<D>(acc);
  const int n_kt = qt + 1;
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      const int nb = (j + 1) & 1;
      load_tile<D>(sK + nb * T, kb, k_sl, (j + 1) * kTile, L, tid);
      load_tile<D>(sV + nb * T, vb, v_sl, (j + 1) * kTile, L, tid);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + (j & 1) * T;
    const __nv_bfloat16* tV = sV + (j & 1) * T;
    const int k0 = j * kTile;

    float p[8][4];
    zero8(p);
    mma_abt<D>(p, sQ, warp * 16, tK, g, t);
    float dp[8][4];
    zero8(dp);
    mma_abt<D>(dp, sdO, warp * 16, tV, g, t);

    const bool edge = (j == qt) || (k0 + kTile > L);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float pe = exp2f(p[nt][e] * scale_log2 - lse2[hr]);
        if (edge) {
          const int key = k0 + nt * 8 + 2 * t + (e & 1);
          if (key > row_a + hr * 8 || key >= L) pe = 0.0f;
        }
        p[nt][e] = pe * (dp[nt][e] - dlt[hr]);  // dS / scale
      }
    }
    mma_pv<D>(acc, p, tK, lane);
    __syncthreads();
  }
  const long o_sl = static_cast<long>(H) * D;
  __nv_bfloat16* out = dq + static_cast<long>(b) * L * o_sl + h * D;
  store_rows<D>(out, o_sl, q0 + warp * 16, L, acc, scale, scale, g, t);
}

// --------------------------------------------------------------- dK / dV
// grid (n_ktiles, Hkv, B); smem: K and V tiles, Q and dO double-buffered,
// LSE and delta rows per query tile. Warp w owns keys k0 + 16w .. + 15.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int L, int H, int Hkv,
                     long q_sb, long q_sl, long q_sh, long k_sb, long k_sl,
                     long k_sh, long v_sb, long v_sl, long v_sh, long d_sb,
                     long d_sl, long d_sh, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int T = Geo<D>::kTileElems;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + T;
  __nv_bfloat16* sQ = sV + T;       // 2 buffers
  __nv_bfloat16* sdO = sQ + 2 * T;  // 2 buffers
  float* sL = reinterpret_cast<float*>(sdO + 2 * T);  // [2][64] lse
  float* sD = sL + 2 * kTile;                          // [2][64] delta

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kt = blockIdx.x;  // the diagonal makes early key tiles longest
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int k0 = kt * kTile;
  const int n_qt = (L + kTile - 1) / kTile;
  const int nq = n_qt - kt;  // live query tiles per head
  const int n_it = G * nq;

  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  auto load_q_stage = [&](int it, int buf) {
    const int h = hk * G + it / nq;
    const int q0 = (kt + it % nq) * kTile;
    load_tile<D>(sQ + buf * T, q + b * q_sb + h * q_sh, q_sl, q0, L, tid);
    load_tile<D>(sdO + buf * T, dout + b * d_sb + h * d_sh, d_sl, q0, L,
                 tid);
    // one f32 of lse or delta per thread; rows past L are zero-filled
    const int r = tid & (kTile - 1);
    const int row = q0 + r;
    const long i = (static_cast<long>(b) * H + h) * L + (row < L ? row : 0);
    if (tid < kTile) {
      port::cp_async4(sL + buf * kTile + r, lse + i, row < L ? 4 : 0);
    } else {
      port::cp_async4(sD + buf * kTile + r, delta + i, row < L ? 4 : 0);
    }
  };

  load_tile<D>(sK, kb, k_sl, k0, L, tid);
  load_tile<D>(sV, vb, v_sl, k0, L, tid);
  load_q_stage(0, 0);
  port::cp_async_commit();

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
  zero_acc<D>(dk_acc);
  zero_acc<D>(dv_acc);
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, +8

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      load_q_stage(it + 1, (it + 1) & 1);
      port::cp_async_commit();
      port::cp_async_wait<1>();
    } else {
      port::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1;
    const __nv_bfloat16* tQ = sQ + buf * T;
    const __nv_bfloat16* tdO = sdO + buf * T;
    const float* tL = sL + buf * kTile;
    const float* tD = sD + buf * kTile;
    const int q0 = (kt + it % nq) * kTile;

    // S^T (16 keys x 64 queries) and P^T
    float p[8][4];
    zero8(p);
    mma_abt<D>(p, sK, warp * 16, tQ, g, t);
    const bool edge = (q0 == k0) || (q0 + kTile > L);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);  // query within the tile
        float pe = exp2f(p[nt][e] * scale_log2 - tL[ql] * kLog2e);
        if (edge) {
          const int key = key_a + (e >= 2 ? 8 : 0);
          if (key > q0 + ql || q0 + ql >= L) pe = 0.0f;
        }
        p[nt][e] = pe;
      }
    }
    mma_pv<D>(dv_acc, p, tdO, lane);  // dV += P^T dO

    float dp[8][4];  // dP^T = V dO^T (16 keys x 64 queries)
    zero8(dp);
    mma_abt<D>(dp, sV, warp * 16, tdO, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        dp[nt][e] = p[nt][e] * (dp[nt][e] - tD[ql]);  // dS^T / scale
      }
    }
    mma_pv<D>(dk_acc, dp, tQ, lane);  // dK += dS^T Q
    __syncthreads();
  }

  const long o_sl = static_cast<long>(Hkv) * D;
  const long off = static_cast<long>(b) * L * o_sl + hk * D;
  store_rows<D>(dk + off, o_sl, k0 + warp * 16, L, dk_acc, scale, scale, g,
                t);
  store_rows<D>(dv + off, o_sl, k0 + warp * 16, L, dv_acc, 1.0f, 1.0f, g, t);
}

template <int D>
constexpr int fwd_smem() { return 5 * Geo<D>::kTileElems * 2; }
template <int D>
constexpr int dq_smem() { return 6 * Geo<D>::kTileElems * 2; }
template <int D>
constexpr int dkv_smem() {
  return 6 * Geo<D>::kTileElems * 2 + 4 * kTile * 4;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int L, int H, int Hkv, const long long* qs,
               const long long* ks, const long long* vs, float scale,
               cudaStream_t s) {
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, fwd_smem<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), L, H, Hkv, qs[0], qs[1], qs[2], ks[0], ks[1],
      ks[2], vs[0], vs[1], vs[2], scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int L,
              int H, int Hkv, const long long* qs, const long long* ks,
              const long long* vs, const long long* ds, float scale,
              cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, dq_smem<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), L, H, Hkv, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], ds[0], ds[1], ds[2], scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int L, int H, int Hkv, const long long* qs,
               const long long* ks, const long long* vs, const long long* ds,
               float scale, cudaStream_t s) {
  auto kern = flash_bwd_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, Hkv, B);
  kern<<<grid, kThreads, dkv_smem<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), L, H,
      Hkv, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      ds[0], ds[1], ds[2], scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All three launch on `stream` and return cudaGetLastError() (0 on
// success); 1 (cudaErrorInvalidValue) for a head_dim other than 64 or 128.
// q, k, v, dO: bf16 (B, L, heads, D), 16-byte aligned, D contiguous, every
// other stride (elements, given as {batch, length, head}) a multiple of 8.
// H % Hkv == 0. o, dq: (B, L, H, D) bf16 contiguous; dk, dv: (B, L, Hkv, D)
// bf16 contiguous; lse, delta: (B, H, L) f32 contiguous.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int L, int H,
                                int Hkv, int D, const long long* q_strides,
                                const long long* k_strides,
                                const long long* v_strides, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, L, H, Hkv, q_strides,
                           k_strides, v_strides, scale, s);
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, L, H, Hkv, q_strides,
                          k_strides, v_strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int L, int H, int Hkv,
                                   int D, const long long* q_strides,
                                   const long long* k_strides,
                                   const long long* v_strides,
                                   const long long* do_strides, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, L, H, Hkv,
                          q_strides, k_strides, v_strides, do_strides, scale,
                          s);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, L, H, Hkv,
                         q_strides, k_strides, v_strides, do_strides, scale,
                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int L, int H,
                                    int Hkv, int D,
                                    const long long* q_strides,
                                    const long long* k_strides,
                                    const long long* v_strides,
                                    const long long* do_strides, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, L, H, Hkv,
                           q_strides, k_strides, v_strides, do_strides, scale,
                           s);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, L, H, Hkv,
                          q_strides, k_strides, v_strides, do_strides, scale,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
