// The five layout probes of the Mosaic probe tool, for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernels of tools/probe_mosaic_ops.py (the five bodies
// launched by `run` -> pl.pallas_call). On the TPU they asked which Mosaic
// layouts the fused Res2 kernel could use; here the same functions ask the
// same questions of Hopper's shared memory and mma.sync fragments. x is
// [F, T, W] bf16 with W = 26, so a row of x is 52 bytes: 4-byte aligned, not
// 16-byte aligned.
//
//   a  out[f, t]     = 2 x[f, t + 1]              t < T - 2
//      read of a shared-memory tile at a row offset of 52 bytes
//   b  out[f, t + 2] = x[f, t],  out[f, 0:2] = 0
//      store into a shared-memory tile at a row offset of 104 bytes
//   c  out = 2 x over the flat [F*T, W] view, 16-row tiles (16 does not
//      divide T = 50, so tiles straddle rows of F)
//   d  out[f, t] = sum_{df, dt < 3} xp[f + df, t + dt] @ w9[(3 df + dt) W : +W]
//      xp = x zero-padded by 1 on each side of F; a 3x3 conv as one product
//      of M = F (T-2) = 768, N = 26 -> 32, K = 9W = 234 -> 240, on the
//      tensor cores, its A fragments read straight from the 52-byte rows
//   e  h = bf16(x.reshape(F T, W) @ w2),  out = h[:, :W] + h[:, W:]
//      a product of N = 52 -> 56 whose output is split at column 26, which
//      lies inside an 8-column mma tile
//
// d and e run mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16
// in, fp32 accumulate, bf16 out, as jnp.dot(..., preferred_element_type=
// float32).astype(bf16) on the MXU).
//
// Fragment loads (the answer d and e give for the fast Res2 kernel):
// - Plain 32-bit shared-memory loads, no ldmatrix. An mma A register holds
//   two neighbouring k of one row; with W even, such a pair never straddles
//   a tap (k = tap*W + c with c even), and its address is 4-byte aligned in
//   any 52-byte row. ldmatrix needs each 8-element row segment 16-byte
//   aligned and inside one tap; that means a channel stride padded from 26
//   to 32 per tap, K = 288 instead of 240 (20% more mma instructions) and
//   a 23% larger shared tile.
// - The lane split of e stays in registers: the column j + 26 that column j
//   adds lies in n-tile (j/8 + 3) one lane to the right in the quad, or in
//   n-tile (j/8 + 4) three lanes to the left, so two __shfl_sync per
//   register pair replace a round trip through shared memory.
//
// What bounds them on the H100: nothing but the launch. Each moves < 100 KB
// and does < 10 MFLOP, ~0.03 us at 3.35 TB/s against a launch of a few us.
// They are one block per row of F (a, b, d) or per 16 or 64 flat rows
// (c, e); the layouts, not the speed, are the point. So the tool runs all
// five in one launch (s3d_probe_all: 111 blocks at F = 16, T = 50, one
// wave), which pays the launch once; each probe keeps its own entry too.
// s3d_probe_empty launches an empty kernel, the floor of a launch, and
// s3d_probe_mma_rate measures the card's mma.sync TF32 rate, the ceiling of
// the port's 3xTF32 kernels (fbank.cu, res2_block.cu).
//
// Plain C interface (bound with ctypes); every entry point returns
// cudaGetLastError() right after its launch, or cudaErrorInvalidValue for a
// shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "tf32_mma.cuh"

namespace {

constexpr int PW = 26;                 // W of probes d and e
constexpr int D_K = 9 * PW;            // 234
constexpr int D_KPAD = 240;            // K rounded up to mma's k = 16
constexpr int D_NPAD = 32;             // N = 26 rounded up to mma's n = 8
constexpr int D_NT = D_NPAD / 8;       // n-tiles
constexpr int D_BLD = D_KPAD + 8;      // Bt row stride in bf16: 124 words, so
                                       // the 8 rows a B load touches hit
                                       // distinct banks
constexpr int E_KPAD = 32;             // K = 26 rounded up to k = 16
constexpr int E_N = 2 * PW;            // 52
constexpr int E_NT = 7;                // 56 / 8 n-tiles
constexpr int E_LD = E_KPAD + 8;       // A and Bt row stride in bf16 (20 words)
constexpr int E_WARPS = 4;             // m-tiles of 16 rows per block
constexpr int C_ROWS = 16;             // probe c's row tile
constexpr int THREADS = 128;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ bf162 as_bf162(uint32_t v) {
  bf162 h;
  memcpy(&h, &v, 4);
  return h;
}

__device__ __forceinline__ uint32_t as_u32(bf162 h) {
  uint32_t v;
  memcpy(&v, &h, 4);
  return v;
}

// two fp32 -> one register of two bf16 (round to nearest even; lo = lower
// column, at the lower address)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Each probe is a device body run by one block of THREADS threads, block
// `blk` of the probe's grid, on `smem` (dynamic shared memory): its own
// kernel runs it with blockIdx.x, the fused kernel with its block's index
// within the probe's range.

// a: one block per f; the [T, W] tile of x in shared memory, read back from
// row 1 on (a word offset of W/2, 52 bytes at W = 26)
__device__ __forceinline__ void probe_a_body(const uint32_t* __restrict__ x,
                                             uint32_t* __restrict__ out, int T,
                                             int W2, int blk, uint32_t* smem) {
  const uint32_t* xf = x + (size_t)blk * T * W2;
  for (int i = threadIdx.x; i < T * W2; i += THREADS) smem[i] = xf[i];
  __syncthreads();
  const bf162 two = __float2bfloat162_rn(2.f);
  uint32_t* of = out + (size_t)blk * (T - 2) * W2;
  for (int i = threadIdx.x; i < (T - 2) * W2; i += THREADS)
    of[i] = as_u32(__hmul2(as_bf162(smem[W2 + i]), two));
}

// b: one block per f; x's rows stored into the shared tile from row 2 on
// (104 bytes in at W = 26), rows 0-1 zeroed, then the tile copied out
__device__ __forceinline__ void probe_b_body(const uint32_t* __restrict__ x,
                                             uint32_t* __restrict__ out, int T,
                                             int W2, int blk, uint32_t* smem) {
  const uint32_t* xf = x + (size_t)blk * T * W2;
  for (int i = threadIdx.x; i < (T - 2) * W2; i += THREADS)
    smem[2 * W2 + i] = xf[i];
  for (int i = threadIdx.x; i < 2 * W2; i += THREADS) smem[i] = 0u;
  __syncthreads();
  uint32_t* of = out + (size_t)blk * T * W2;
  for (int i = threadIdx.x; i < T * W2; i += THREADS) of[i] = smem[i];
}

// c: one block per C_ROWS rows of the flat [F*T, W] view; the last tile is
// masked when C_ROWS does not divide F*T
__device__ __forceinline__ void probe_c_body(const uint32_t* __restrict__ x,
                                             uint32_t* __restrict__ out,
                                             int n_rows, int W2, int blk,
                                             uint32_t* smem) {
  const int r0 = blk * C_ROWS;
  const int n = min(C_ROWS, n_rows - r0) * W2;
  const size_t base = (size_t)r0 * W2;
  for (int i = threadIdx.x; i < n; i += THREADS) smem[i] = x[base + i];
  __syncthreads();
  const bf162 two = __float2bfloat162_rn(2.f);
  for (int i = threadIdx.x; i < n; i += THREADS)
    out[base + i] = as_u32(__hmul2(as_bf162(smem[i]), two));
}

// d: one block per f, one warp per 16 output rows (t). Shared memory holds
// xp[f .. f+2] as three [T, W] planes of 52-byte rows (zero outside F) and
// w9 transposed to [N_PAD][D_BLD] (B is "col": k contiguous per n). Warps
// past the last output row load zeros and store nothing, but reach the
// barrier with the rest of the block.
__device__ __forceinline__ void probe_d_body(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w9,
                                             bf16* __restrict__ out, int F,
                                             int T, int blk, uint32_t* smem) {
  constexpr int W2 = PW / 2;
  uint32_t* xs = smem;                                  // [3][T][W2] words
  bf16* bt = reinterpret_cast<bf16*>(smem + 3 * T * W2);  // [D_NPAD][D_BLD]
  const int f = blk;
  const int To = T - 2;
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);
  for (int i = threadIdx.x; i < 3 * T * W2; i += blockDim.x) {
    const int fp = f + i / (T * W2) - 1;
    xs[i] = (fp >= 0 && fp < F) ? x32[(size_t)fp * T * W2 + i % (T * W2)] : 0u;
  }
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < D_NPAD * D_BLD; i += blockDim.x) {
    const int n = i / D_BLD, k = i % D_BLD;
    bt[i] = (n < PW && k < D_K) ? w9[k * PW + n] : zero;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
  const int rows[2] = {m0 + g, m0 + g + 8};
  const uint32_t* bt32 = reinterpret_cast<const uint32_t*>(bt);
  float acc[D_NT][4] = {};
  for (int ks = 0; ks < D_KPAD / 16; ++ks) {
    uint32_t a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // a[q]: row rows[q & 1], k k0 + 8 (q >> 1)
      const int r = rows[q & 1];
      const int k = ks * 16 + 2 * tq + 8 * (q >> 1);
      uint32_t v = 0u;
      if (r < To && k < D_K) {
        const int tap = k / PW, c = k - tap * PW;
        const int df = tap / 3, dt = tap - 3 * df;
        v = xs[(df * T + r + dt) * W2 + c / 2];
      }
      a[q] = v;
    }
#pragma unroll
    for (int nt = 0; nt < D_NT; ++nt) {
      const int row = (nt * 8 + g) * D_BLD + ks * 16 + 2 * tq;
      const uint32_t b[2] = {bt32[row / 2], bt32[row / 2 + 4]};
      mma_bf16(acc[nt], a, b);
    }
  }
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int nt = 0; nt < D_NT; ++nt) {
    const int n = nt * 8 + 2 * tq;  // n even, so n < 26 implies n + 1 < 26
    if (n >= PW) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= To) continue;
      o32[(((size_t)f * To + rows[h]) * PW + n) / 2] =
          pack_bf16(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// e: E_WARPS m-tiles of 16 flat rows per block. Shared memory holds the
// block's rows of x ([64][E_LD], K zero-padded to 32) and w2 transposed
// ([56][E_LD], N zero-padded to 56).
__device__ __forceinline__ void probe_e_body(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w2,
                                             bf16* __restrict__ out,
                                             int n_rows, int blk,
                                             uint32_t* smem) {
  uint32_t* as32 = smem;                                 // [64][E_LD] bf16
  uint32_t* bt32 = smem + E_WARPS * 16 * E_LD / 2;       // [56][E_LD] bf16
  bf16* as = reinterpret_cast<bf16*>(as32);
  bf16* bt = reinterpret_cast<bf16*>(bt32);
  const int r_blk = blk * E_WARPS * 16;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < E_WARPS * 16 * E_LD; i += blockDim.x) {
    const int r = r_blk + i / E_LD, k = i % E_LD;
    as[i] = (r < n_rows && k < PW) ? x[(size_t)r * PW + k] : zero;
  }
  for (int i = threadIdx.x; i < E_NT * 8 * E_LD; i += blockDim.x) {
    const int n = i / E_LD, k = i % E_LD;
    bt[i] = (n < E_N && k < PW) ? w2[k * E_N + n] : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = r_blk + warp * 16;
  if (m0 >= n_rows) return;  // a whole warp: no shuffle is left half-done
  float acc[E_NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < E_KPAD / 16; ++ks) {
    const int arow = (warp * 16 + g) * E_LD + ks * 16 + 2 * tq;
    const uint32_t a[4] = {as32[arow / 2], as32[(arow + 8 * E_LD) / 2],
                           as32[arow / 2 + 4], as32[(arow + 8 * E_LD) / 2 + 4]};
#pragma unroll
    for (int nt = 0; nt < E_NT; ++nt) {
      const int brow = (nt * 8 + g) * E_LD + ks * 16 + 2 * tq;
      const uint32_t b[2] = {bt32[brow / 2], bt32[brow / 2 + 4]};
      mma_bf16(acc[nt], a, b);
    }
  }
  // h = bf16(acc): per n-tile, columns nt*8 + 2tq (+1) of rows g and g + 8
  uint32_t h[E_NT + 1][2];
#pragma unroll
  for (int nt = 0; nt < E_NT; ++nt) {
    h[nt][0] = pack_bf16(acc[nt][0], acc[nt][1]);
    h[nt][1] = pack_bf16(acc[nt][2], acc[nt][3]);
  }
  h[E_NT][0] = h[E_NT][1] = 0u;
  // out column j = jt*8 + 2tq adds h column j + 26: n-tile jt + 3 at column
  // 2tq + 2 (lane tq + 1) when tq < 3, n-tile jt + 4 at column 0 (lane 0)
  // when tq = 3
  const int src = (lane & ~3) | ((tq + 1) & 3);
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int jt = 0; jt < 4; ++jt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t u = __shfl_sync(0xffffffffu, h[jt + 3][hh], src);
      const uint32_t v = __shfl_sync(0xffffffffu, h[jt + 4][hh], src);
      const int j = jt * 8 + 2 * tq;
      const int r = m0 + g + 8 * hh;
      if (j >= PW || r >= n_rows) continue;
      const float2 own = __bfloat1622float2(as_bf162(h[jt][hh]));
      const float2 oth = __bfloat1622float2(as_bf162(tq < 3 ? u : v));
      o32[((size_t)r * PW + j) / 2] = pack_bf16(own.x + oth.x, own.y + oth.y);
    }
  }
}

constexpr int E_SMEM = (E_WARPS * 16 + E_NT * 8) * E_LD * 2;  // bytes

// Shared-memory bytes of each probe at x [F, T, W].
__host__ __device__ inline int smem_ab(int T, int W) { return T * W * 2; }
__host__ __device__ inline int smem_c(int W) { return C_ROWS * W * 2; }
__host__ __device__ inline int smem_d(int T) {
  return 3 * T * PW * 2 + D_NPAD * D_BLD * 2;
}

__global__ void __launch_bounds__(THREADS)
probe_a_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               int T, int W2) {
  extern __shared__ __align__(16) uint32_t smem[];
  probe_a_body(x, out, T, W2, blockIdx.x, smem);
}

__global__ void __launch_bounds__(THREADS)
probe_b_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               int T, int W2) {
  extern __shared__ __align__(16) uint32_t smem[];
  probe_b_body(x, out, T, W2, blockIdx.x, smem);
}

__global__ void __launch_bounds__(THREADS)
probe_c_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               int n_rows, int W2) {
  extern __shared__ __align__(16) uint32_t smem[];
  probe_c_body(x, out, n_rows, W2, blockIdx.x, smem);
}

__global__ void __launch_bounds__(THREADS)
probe_d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
               bf16* __restrict__ out, int F, int T) {
  extern __shared__ __align__(16) uint32_t smem[];
  probe_d_body(x, w9, out, F, T, blockIdx.x, smem);
}

__global__ void __launch_bounds__(32 * E_WARPS)
probe_e_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w2,
               bf16* __restrict__ out, int n_rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  probe_e_body(x, w2, out, n_rows, blockIdx.x, smem);
}

// All five probes in one launch, at x [F, T, W]: blocks [0, F) run a, the
// next F b, the next ceil(F T / C_ROWS) c, the next F d, the last
// ceil(F T / 64) e, each block one probe's body (a branch uniform over the
// block, so every barrier is reached by all its threads). THREADS threads
// and the largest shared memory any probe needs.
__global__ void __launch_bounds__(THREADS)
probe_all_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w9,
                 const bf16* __restrict__ w2, bf16* __restrict__ out_a,
                 bf16* __restrict__ out_b, bf16* __restrict__ out_c,
                 bf16* __restrict__ out_d, bf16* __restrict__ out_e, int F,
                 int T) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int W2 = PW / 2;
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);
  const int n_rows = F * T;
  int blk = blockIdx.x;
  if (blk < F) {
    probe_a_body(x32, reinterpret_cast<uint32_t*>(out_a), T, W2, blk, smem);
    return;
  }
  blk -= F;
  if (blk < F) {
    probe_b_body(x32, reinterpret_cast<uint32_t*>(out_b), T, W2, blk, smem);
    return;
  }
  blk -= F;
  const int nc = (n_rows + C_ROWS - 1) / C_ROWS;
  if (blk < nc) {
    probe_c_body(x32, reinterpret_cast<uint32_t*>(out_c), n_rows, W2, blk, smem);
    return;
  }
  blk -= nc;
  if (blk < F) {
    probe_d_body(x, w9, out_d, F, T, blk, smem);
    return;
  }
  probe_e_body(x, w2, out_e, n_rows, blk - F, smem);
}

__global__ void empty_kernel() {}

// The rate at which the card runs mma.sync.m16n8k8 TF32 (the instruction of
// the port's 3xTF32 kernels): each warp runs `iters` rounds of MMA_CHAINS
// independent products on registers, with no memory traffic in the loop;
// out[thread] keeps every sum live.
constexpr int MMA_CHAINS = 8;

__global__ void mma_rate_kernel(float* __restrict__ out, int iters) {
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t a[4] = {0x3f800000u ^ (lane << 13), 0x3f000000u, 0x3e800000u, 0x3f400000u};
  const uint32_t b0 = 0x3c000000u ^ (lane << 13), b1 = 0x3c800000u;
  float d[MMA_CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < MMA_CHAINS; ++j) s3d::mma(d[j], a, b0, b1);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < MMA_CHAINS; ++j) sum += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

cudaError_t set_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

const char* s3d_errstr(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [F, T, W], out [F, T-2, W]; bf16, contiguous, W even, T >= 3.
int s3d_probe_a(const void* x, void* out, int F, int T, int W, void* stream) {
  if (F < 1 || T < 3 || W < 2 || W % 2) return (int)cudaErrorInvalidValue;
  const int smem = smem_ab(T, W);
  cudaError_t err = set_smem((const void*)probe_a_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  probe_a_kernel<<<F, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), T, W / 2);
  return (int)cudaGetLastError();
}

// x [F, T, W], out [F, T, W]; bf16, contiguous, W even, T >= 3.
int s3d_probe_b(const void* x, void* out, int F, int T, int W, void* stream) {
  if (F < 1 || T < 3 || W < 2 || W % 2) return (int)cudaErrorInvalidValue;
  const int smem = smem_ab(T, W);
  cudaError_t err = set_smem((const void*)probe_b_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  probe_b_kernel<<<F, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), T, W / 2);
  return (int)cudaGetLastError();
}

// x [F, T, W], out [F, T, W]; bf16, contiguous, W even.
int s3d_probe_c(const void* x, void* out, int F, int T, int W, void* stream) {
  if (F < 1 || T < 1 || W < 2 || W % 2) return (int)cudaErrorInvalidValue;
  const int n_rows = F * T;
  probe_c_kernel<<<(n_rows + C_ROWS - 1) / C_ROWS, THREADS, smem_c(W),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n_rows,
      W / 2);
  return (int)cudaGetLastError();
}

// x [F, T, 26], w9 [234, 26], out [F, T-2, 26]; bf16, contiguous, T <= 66
// (one warp per 16 output rows, at most four warps).
int s3d_probe_d(const void* x, const void* w9, void* out, int F, int T, int W,
                void* stream) {
  if (F < 1 || T < 3 || T - 2 > 16 * (THREADS / 32) || W != PW)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_d(T);
  cudaError_t err = set_smem((const void*)probe_d_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int warps = (T - 2 + 15) / 16;
  probe_d_kernel<<<F, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w9),
      static_cast<bf16*>(out), F, T);
  return (int)cudaGetLastError();
}

// x [F, T, 26], w2 [26, 52], out [F, T, 26]; bf16, contiguous.
int s3d_probe_e(const void* x, const void* w2, void* out, int F, int T, int W,
                void* stream) {
  if (F < 1 || T < 1 || W != PW) return (int)cudaErrorInvalidValue;
  const int n_rows = F * T;
  const int rows_per_block = 16 * E_WARPS;
  probe_e_kernel<<<(n_rows + rows_per_block - 1) / rows_per_block,
                   32 * E_WARPS, E_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), n_rows);
  return (int)cudaGetLastError();
}

// x [F, T, 26], w9 [234, 26], w2 [26, 52]; out_a, out_d [F, T-2, 26],
// out_b, out_c, out_e [F, T, 26]; bf16, contiguous. The shapes every
// per-probe entry takes: 3 <= T <= 66.
int s3d_probe_all(const void* x, const void* w9, const void* w2, void* out_a,
                  void* out_b, void* out_c, void* out_d, void* out_e, int F,
                  int T, int W, void* stream) {
  if (F < 1 || T < 3 || T - 2 > 16 * (THREADS / 32) || W != PW)
    return (int)cudaErrorInvalidValue;
  const int smem = max(max(smem_ab(T, W), smem_c(W)), max(smem_d(T), E_SMEM));
  cudaError_t err = set_smem((const void*)probe_all_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = F * T;
  const int blocks = 3 * F + (n_rows + C_ROWS - 1) / C_ROWS +
                     (n_rows + 16 * E_WARPS - 1) / (16 * E_WARPS);
  probe_all_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w9),
      static_cast<const bf16*>(w2), static_cast<bf16*>(out_a),
      static_cast<bf16*>(out_b), static_cast<bf16*>(out_c),
      static_cast<bf16*>(out_d), static_cast<bf16*>(out_e), F, T);
  return (int)cudaGetLastError();
}

// blocks x threads threads, each warp iters x MMA_CHAINS mma.sync TF32
// products; out [blocks * threads] fp32.
int s3d_probe_mma_rate(void* out, int blocks, int threads, int iters,
                       void* stream) {
  if (blocks < 1 || threads < 32 || threads > 1024 || threads % 32 || iters < 1)
    return (int)cudaErrorInvalidValue;
  mma_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

// An empty kernel, one warp: the floor of a launch through this interface.
int s3d_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
