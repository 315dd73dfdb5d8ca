// Device helpers shared by the port's 3xTF32 tensor-core kernels (fbank.cu,
// res2_block.cu): the operand split, the mma.sync.m16n8k8 TF32 product and
// cp.async staging into shared memory.
//
// 3xTF32 keeps fp32-level error on the tensor cores: a = a_b + a_s with
// a_b = rna_tf32(a), a_s = rna_tf32(a - a_b), and a*b ~ a_s*b_b + a_b*b_s +
// a_b*b_b (the small cross terms first). The host packs each weight into
// B-fragment order once (ops/kernels/tf32.py pack_b); A is split in
// registers as it is loaded.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace s3d {

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small + O(2^-22 |v|); big's low 13 bits are cleared, so v - big
// is exact and the tensor cores see big as it is.
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v) & 0xffffe000u;
  small = tf32_rna(v - __uint_as_float(big));
}

// d += a * b, m16n8k8, TF32 in, fp32 accumulate. Lane (g, t) = (lane/4,
// lane%4): a = {(g, t), (g+8, t), (g, t+4), (g+8, t+4)} of [row, k];
// b = {(k t, n g), (k t+4, n g)}; d = {(g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)} of [row, n].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b from a zero accumulator (C is the constant 0).
__device__ __forceinline__ void mma_c0(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// d[j] = a * b_j in 3xTF32 for N n-tiles, each from a zero accumulator: a
// split (ab, as), b_j the lane's packed float4 of n-tile j (b0 big, b1 big,
// b0 small, b1 small) at bp[j * stride]. Pass by pass, the small cross
// terms first, so that consecutive mma are independent and N chains of
// three are in flight at once. The caller adds d to its running sum in
// fp32 (round to nearest): the tensor cores' own accumulation truncates,
// and over long K that error outgrows the split's several times.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const float4* bp, int stride) {
  float4 b[N];
#pragma unroll
  for (int j = 0; j < N; ++j) b[j] = bp[j * stride];
#pragma unroll
  for (int j = 0; j < N; ++j) mma_c0(d[j], as, __float_as_uint(b[j].x), __float_as_uint(b[j].y));
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], ab, __float_as_uint(b[j].z), __float_as_uint(b[j].w));
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], ab, __float_as_uint(b[j].x), __float_as_uint(b[j].y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

}  // namespace s3d
