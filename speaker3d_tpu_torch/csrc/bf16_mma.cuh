// Device helpers of the port's bf16 tensor-core kernels (res2_block.cu's
// bf16 instantiation): bf16 bits in and out of fp32, and the
// mma.sync.m16n8k16 BF16 product with fp32 accumulation.
//
// Activations are kept as raw bf16 bits (uint16_t), so that a source needs
// no bf16 arithmetic operators: every sum and product runs in fp32 and is
// rounded to bf16 (to nearest, ties to even) where it is stored. The host
// packs each weight into B-fragment order once
// (ops/kernels/res2_block_kernel.py pack_b_bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s3d {

__device__ __forceinline__ uint16_t bf16_rn(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// Two bf16 of consecutive k in one register: the lower k in the low half.
__device__ __forceinline__ uint32_t bf16x2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a * b, m16n8k16, BF16 in, fp32 accumulate. Lane (g, t) = (lane/4,
// lane%4), each register two consecutive k: a = {(g, 2t), (g+8, 2t),
// (g, 2t+8), (g+8, 2t+8)} of [row, k]; b = {(k 2t, n g), (k 2t+8, n g)};
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)} of [row, n].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace s3d
