// The NF4 decode shared by every NF4 kernel (the Nf4Thin and Nf4Fwd policies
// in nf4_matmul.cu, the Nf4Dx policy in nf4_matmul_bwd.cu), so the forward
// routes and the backward cannot drift apart: the 16-entry codebook and
// the double-quantized absmax, with the reference codec's rounding points
// (llm_in_practise_tpu/quant/nf4.py; __fmul_rn / __fadd_rn keep nvcc from
// contracting them into an FMA).
//
// The codebook is read from shared memory (16 distinct words in 16 banks;
// equal indices broadcast), not from __constant__ memory, whose reads
// serialise on divergent indices: each block copies kNF4 to s_code once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nf4 {

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

__shared__ float s_code[16];

// threads 0-15 of the block copy the codebook; the caller synchronises
// before the first read
__device__ __forceinline__ void fill_codebook() {
  if (threadIdx.x < 16) s_code[threadIdx.x] = kNF4[threadIdx.x];
}

// double-quantized absmax from its byte q: (q - 128) * scale + offset, each
// step rounded on its own; 2^23 + q, less 2^23 + 128, is q - 128 exactly
__device__ __forceinline__ float absmax(uint32_t q, float scale,
                                        float offset) {
  const float d = __uint_as_float(0x4B000000u | q) - 8388736.0f;
  return __fadd_rn(__fmul_rn(d, scale), offset);
}

// one weight: code * absmax in f32 (the caller rounds it once to bf16)
__device__ __forceinline__ float weight(uint32_t code, float am) {
  return __fmul_rn(s_code[code], am);
}

// the same, from the code's byte offset into the codebook (4 * code), for
// callers that extract the code already scaled by 4
__device__ __forceinline__ float weight_at(uint32_t offset, float am) {
  return __fmul_rn(
      *reinterpret_cast<const float*>(
          reinterpret_cast<const uint8_t*>(s_code) + offset),
      am);
}

}  // namespace nf4
