// Kaldi log-mel filterbank for Hopper (sm_90a): both contractions on the
// tensor cores in 3xTF32, which is as close as fp32 FMA.
//
// Replaces the TPU kernel speaker3d_tpu/ops/pallas/fbank_kernel.py
// (_fbank_kernel, launched by pallas_fbank -> _build -> pl.pallas_call).
// Same function, per frame of frame_len samples at stride frame_shift:
//
//   y     = frame @ B            B [frame_len, 2R]: DC removal, pre-emphasis,
//                                window and the padded rDFT folded into one
//                                matrix (ops/fbank.py analysis_matrix), R =
//                                n_bins + 1 for a padded window of 2 n_bins
//   p[k]  = y_re[k]^2 + y_im[k]^2   (sqrt of it when use_power == 0)
//   out   = log(max(p @ mel, FLT_EPSILON))   mel [R, M]   (no log when
//                                            use_log == 0)
//
// What bounds it on the H100: operations. A [64, 48000] batch is 8.6 GFLOP
// of fp32-accurate products against ~19 MB moved. The path asks for fp32
// results, and one TF32 pass is ~3e-2 off in the strong bins (the CPU
// emulation in tests/test_torch_fbank_tf32.py), so each product is three
// TF32 mma (tf32_mma.cuh): 3 x 8.6 GFLOP at 495 TFLOP/s dense TF32 is
// 0.052 ms. mma.sync itself issues below that rate: ~317 TFLOP/s on an H100
// SXM at 700 W (the "[K1 ceiling]" line of chip_smoke.py), 0.081 ms.
//
// Design:
// - Operands packed once, on the host (ops/kernels/fbank_kernel.py
//   pack_fbank): B's bins 0..n_bins-1 with their columns interleaved as
//   (re_k, im_k), so that the m16n8k8 C fragment of a lane holds the real
//   and imaginary parts of one bin side by side, and mel's rows
//   0..n_bins-1, each split into rna-TF32 big and small parts in B-fragment
//   order (at 16 kHz K = 400 is 50 k-steps, N = 512 and 80). The Nyquist
//   bin is skipped: its mel row is zero (the wrapper checks).
// - n_bins is a launch argument: half the power-of-two Kaldi window, 128
//   (8 kHz, 200-sample frames) to 1024 (48 kHz, 1200), a multiple of 64 so
//   that the bin chunks split evenly over two warps. The frame length and
//   shift are launch arguments too; the skew below takes any shift.
// - Tile: one block per run of 16 W frames of one batch row, W m-tiles of
//   16 frames. The launch picks W per shape (pick_tile) so that the grid
//   fills the 132 SMs in as few rounds as it can: W = 5 at [64, 24000], 10
//   at [64, 48000] (298 frames, 128 blocks, one round), 12 at [64, 120000].
//   Where W <= 8, two warps share each m-tile, each taking half the bin
//   chunks, and sum their mel outputs at the end: an SM with few warps
//   cannot hide the latency of their loads and mma chains.
// - Frames are read straight from the waveform: the block stages the span
//   of samples its frames cover in shared memory once, skewed (at 16 kHz
//   sample s at s + 4 floor(s / 160)), so a frame row is 164 floats, 4 mod
//   32 banks (100 at 8 kHz, 484 at 48 kHz), and the 32 lanes of an A
//   fragment load from 32 banks. A is split into big and small in
//   registers.
// - The products run bin chunk by bin chunk (8 n-tiles, 32 bins): the DFT
//   over K, then the power in registers (the C fragments of n-tiles 2j and
//   2j+1 are exactly the A fragment of mel k-step j, so y and the power
//   never leave the registers), then the chunk's 4 mel k-steps into an
//   [16, 80] accumulator per warp. Each k-step's three products start from
//   zero and are added to the running sum in fp32; the three passes run
//   over 8 n-tiles at once (tf32_mma.cuh mma3), so 8 chains are in flight.
// - B and mel reach shared memory by cp.async in stages of 80 fragments
//   (10 DFT k-steps x 8 n-tiles, or 5 x 16 when two warps split the
//   chunks; or the chunks' mel k-steps), double buffered: stage s + 1 lands
//   while stage s is multiplied, shared by all warps. Every block reads the
//   packed B once from L2 (1.6 MB at 16 kHz, 19.7 MB at 48 kHz).
// - Frames past the end of a row (the ragged last tile) compute and are
//   masked on store.
//
// Plain C interface (bound with ctypes); every entry point returns
// cudaGetLastError() right after its launch, or cudaErrorInvalidValue for a
// shape it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

#include "tf32_mma.cuh"

namespace {

using s3d::cp_async16;
using s3d::cp_async_commit;
using s3d::cp_async_wait1;
using s3d::mma3;
using s3d::split;

constexpr int BC = 8;          // n-tiles per bin chunk (32 bins)
constexpr int MEL_KS = BC / 2;  // mel k-steps per bin chunk
constexpr int MAX_NMT = 10;    // mel n-tiles (M <= 80)
constexpr int MAX_NS = 2;      // warps that split one m-tile's bin chunks
constexpr int KC = 10;         // DFT k-steps per stage and bin chunk, over NS
constexpr int STAGE_F4 = KC * BC * 32;  // float4 per stage buffer (40 KB)
constexpr int DFT_NG = 8;      // n-tiles whose mma chains run together
constexpr int MEL_NG = 5;
constexpr int WMAX = 16;       // warps per block
constexpr int MIN_BUSY = 4;    // below this many warps an SM is not busier
constexpr int MAX_SMEM = 232448;
constexpr int MIN_BINS = 128;  // rDFT bins: 8 kHz (a 256-point window) ..
constexpr int MAX_BINS = 1024;  // .. 48 kHz (2048)
constexpr int BIN_STEP = 4 * BC * MAX_NS;  // bins in a bin chunk per warp split
static_assert(MAX_NS * MEL_KS * MAX_NMT * 32 <= STAGE_F4, "a mel stage fits a buffer");
static_assert(KC % MAX_NS == 0, "stages split evenly");
static_assert((MAX_NS - 1) * (WMAX / MAX_NS) * MAX_NMT * 4 * 32 <= 2 * STAGE_F4 * 4,
              "the reduction over the split fits the stage buffers");

// Skew of the staged samples: a frame row of shift + pad floats, 4 mod 32.
__host__ __device__ inline int skew_pad(int shift) {
  return ((4 - shift % 32) % 32 + 32) % 32;
}

// Samples a block of wm m-tiles stages, and its shared-memory bytes.
__host__ __device__ inline int seg_len(int wm, int shift, int nks) {
  return (16 * wm - 1) * shift + 8 * nks;
}

int smem_bytes(int wm, int shift, int nks) {
  const int n = seg_len(wm, shift, nks);
  const int skewed = n + skew_pad(shift) * ((n - 1) / shift);
  return 2 * STAGE_F4 * 16 + 4 * (8 * nks) + 4 * skewed;
}

struct Tile {
  int wm, ns;  // m-tiles (16 frames each) per block, warps per m-tile
};

// The block: the fewest rounds of blocks over the SMs, at the work a round
// costs an SM (its m-tiles, or MIN_BUSY where fewer leave it underused);
// ties go to more m-tiles (fewer blocks read B). Two warps share each m-tile
// (half the bin chunks each) where that stays within WMAX warps: an SM with
// few warps cannot hide the latency of their loads and mma chains. wm = 0
// when no block fits in shared memory.
Tile pick_tile(int batch, int n_frames, int shift, int nks, int n_sm) {
  Tile best{0, 1};
  long long best_cost = -1;
  const int most = min(WMAX, (n_frames + 15) / 16);
  for (int wm = 1; wm <= most && smem_bytes(wm, shift, nks) <= MAX_SMEM; ++wm) {
    const long long blocks = (long long)batch * ((n_frames + 16 * wm - 1) / (16 * wm));
    const long long cost = (blocks + n_sm - 1) / n_sm * max(wm, MIN_BUSY);
    if (best_cost < 0 || cost <= best_cost) {
      best.wm = wm;
      best_cost = cost;
    }
  }
  best.ns = MAX_NS * best.wm <= WMAX ? MAX_NS : 1;
  return best;
}

__device__ __forceinline__ float power(float re, float im, int use_power) {
  const float p = re * re + im * im;
  return use_power ? p : sqrtf(p);
}

// NS warps per m-tile, each on every NS-th bin chunk.
template <int NS>
__global__ void __launch_bounds__(32 * WMAX, 1)
fbank_kernel(const float* __restrict__ wav, const float4* __restrict__ bdft,
             const float4* __restrict__ bmel, float* __restrict__ out,
             int n_samples, int n_frames, int tiles_per_row, int shift,
             int nks, int n_bins, int M, int use_power, int use_log) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int wm = (nthr >> 5) / NS;
  const int pad = skew_pad(shift), rs = shift + pad;
  float4* stage = smem4;                                       // [2][STAGE_F4]
  int* koff = reinterpret_cast<int*>(smem4 + 2 * STAGE_F4);    // [8 nks]
  float* seg = reinterpret_cast<float*>(koff + 8 * nks);       // skewed samples
  const int b = blockIdx.x / tiles_per_row;
  const int f0 = (blockIdx.x % tiles_per_row) * 16 * wm;
  const int nmt = (M + 7) / 8;
  const int nt_dft = n_bins / 4;            // n-tiles of the interleaved B
  const int nbc = nt_dft / BC;              // bin chunks, a multiple of NS
  constexpr int kcs = KC / NS;              // DFT k-steps per stage
  const int nkc = (nks + kcs - 1) / kcs;    // DFT stages per chunk group
  const int nst = nbc / NS * (nkc + 1);     // per group: nkc DFT stages, 1 mel

  // stage s of chunk group cg = s / (nkc + 1), the NS bin chunks cg NS ..
  // cg NS + NS - 1 (NS BC consecutive n-tiles): DFT k-steps [q kcs, q kcs +
  // kcs) x the group's n-tiles for q = s % (nkc + 1) < nkc, laid out [k-step]
  // [chunk][n-tile]; else the group's mel k-steps, [chunk][k-step][n-tile]
  auto issue = [&](int s) {
    const int cg = s / (nkc + 1), q = s % (nkc + 1);
    float4* dst = stage + (s & 1) * STAGE_F4;
    if (q < nkc) {
      const int row = NS * BC * 32;
      const int n = min(kcs, nks - q * kcs) * row;
      for (int i = tid; i < n; i += nthr) {
        const int ks = i / row;
        cp_async16(dst + i, bdft + ((size_t)(q * kcs + ks) * nt_dft + cg * NS * BC) * 32 +
                                (i - ks * row));
      }
    } else {
      const int n = NS * MEL_KS * nmt * 32;
      for (int i = tid; i < n; i += nthr)
        cp_async16(dst + i, bmel + (size_t)cg * n + i);
    }
    cp_async_commit();
  };
  issue(0);

  const float* w = wav + (size_t)b * n_samples;
  const long long s0 = (long long)f0 * shift;
  const int n_seg = seg_len(wm, shift, nks);
  for (int i = tid; i < n_seg; i += nthr) {
    const long long s = s0 + i;
    seg[i + pad * (i / shift)] = s < n_samples ? __ldg(w + s) : 0.f;
  }
  for (int k = tid; k < 8 * nks; k += nthr) koff[k] = k + pad * (k / shift);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int mt = warp % wm, ns = warp / wm;  // the warp's m-tile, its chunks
  const float* a_lo = seg + (mt * 16 + g) * rs;  // frame rows g and g + 8
  const float* a_hi = a_lo + 8 * rs;
  float acc[BC][4];            // the chunk's DFT: (re, im) of bin 4j + t
  float o[MAX_NMT][4] = {};    // mel output of the m-tile, this warp's bins

  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) issue(s + 1);
    else cp_async_commit();  // an empty group keeps wait_group 1 exact
    cp_async_wait1();
    __syncthreads();
    const float4* bb = stage + (s & 1) * STAGE_F4 + lane;
    const int q = s % (nkc + 1);
    if (q == 0) {
#pragma unroll
      for (int j = 0; j < BC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    }
    if (q < nkc) {
      const int n = min(kcs, nks - q * kcs);
#pragma unroll
      for (int ksl = 0; ksl < kcs; ++ksl) {
        if (ksl < n) {
          const int k = (q * kcs + ksl) * 8 + t;
          const int lo = koff[k], hi = koff[k + 4];
          uint32_t ab[4], as[4];
          split(a_lo[lo], ab[0], as[0]);
          split(a_hi[lo], ab[1], as[1]);
          split(a_lo[hi], ab[2], as[2]);
          split(a_hi[hi], ab[3], as[3]);
#pragma unroll
          for (int j0 = 0; j0 < BC; j0 += DFT_NG) {
            float d[DFT_NG][4];
            mma3<DFT_NG>(d, ab, as, bb + ((ksl * NS + ns) * BC + j0) * 32, 32);
#pragma unroll
            for (int j = 0; j < DFT_NG; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[j0 + j][i] += d[j][i];
          }
        }
      }
    } else {
      // the power of n-tiles 2j and 2j + 1 (bins 8j + t and 8j + 4 + t at
      // rows g and g + 8) is the A fragment of the chunk's mel k-step j
#pragma unroll
      for (int j = 0; j < MEL_KS; ++j) {
        uint32_t ab[4], as[4];
        split(power(acc[2 * j][0], acc[2 * j][1], use_power), ab[0], as[0]);
        split(power(acc[2 * j][2], acc[2 * j][3], use_power), ab[1], as[1]);
        split(power(acc[2 * j + 1][0], acc[2 * j + 1][1], use_power), ab[2], as[2]);
        split(power(acc[2 * j + 1][2], acc[2 * j + 1][3], use_power), ab[3], as[3]);
        // where nmt is not a multiple of MEL_NG, the last group's n-tiles
        // past nmt multiply what the stage buffer holds there (at most
        // (7 nmt + 5 ceil(nmt / 5)) * 32 float4 in, inside STAGE_F4), and
        // their adds are masked: every n-tile below nmt is summed
#pragma unroll
        for (int m0 = 0; m0 < MAX_NMT; m0 += MEL_NG) {
          if (m0 < nmt) {
            float d[MEL_NG][4];
            mma3<MEL_NG>(d, ab, as, bb + ((ns * MEL_KS + j) * nmt + m0) * 32, 32);
#pragma unroll
            for (int m = 0; m < MEL_NG; ++m)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (m0 + m < nmt) o[m0 + m][i] += d[m][i];
          }
        }
      }
    }
    __syncthreads();
  }

  // the m-tile's other warps hand their sums to warp ns = 0 through the
  // (now idle) stage buffers, lane-contiguous
  if constexpr (NS > 1) {
    float* red = reinterpret_cast<float*>(stage);
    if (ns > 0) {
#pragma unroll
      for (int m = 0; m < MAX_NMT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(((ns - 1) * wm + mt) * MAX_NMT * 4 + m * 4 + i) * 32 + lane] = o[m][i];
    }
    __syncthreads();
    if (ns > 0) return;
    for (int r = 1; r < NS; ++r)
#pragma unroll
      for (int m = 0; m < MAX_NMT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[m][i] += red[(((r - 1) * wm + mt) * MAX_NMT * 4 + m * 4 + i) * 32 + lane];
  }

#pragma unroll
  for (int m8 = 0; m8 < MAX_NMT; ++m8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + mt * 16 + g + 8 * h;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m8 * 8 + 2 * t + i;
        if (m8 < nmt && f < n_frames && m < M) {
          float v = o[m8][2 * h + i];
          if (use_log) v = logf(fmaxf(v, FLT_EPSILON));
          out[((size_t)b * n_frames + f) * M + m] = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* s3d_errstr(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// wav [batch, n_samples] fp32; bdft the packed interleaved B ([nks][n_bins
// / 4][32] float4, nks = ceil(frame_len / 8)), bmel the packed mel rows
// 0..n_bins-1 ([n_bins / 8][ceil(M / 8)][32] float4), out [batch, n_frames,
// M] fp32, M <= 80, n_bins a multiple of 64 in [128, 1024]; contiguous, on
// the device of `stream`.
int s3d_fbank_f32(const void* wav, const void* bdft, const void* bmel,
                  void* out, int batch, int n_samples, int n_frames,
                  int frame_shift, int nks, int n_bins, int M, int use_power,
                  int use_log, void* stream) {
  if (batch < 1 || n_frames < 1 || frame_shift < 1 || nks < 1 || M < 1 ||
      M > 8 * MAX_NMT || n_bins < MIN_BINS || n_bins > MAX_BINS ||
      n_bins % BIN_STEP)
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Tile tile = pick_tile(batch, n_frames, frame_shift, nks, n_sm);
  if (tile.wm == 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(tile.wm, frame_shift, nks);
  auto kernel = tile.ns == MAX_NS ? fbank_kernel<MAX_NS> : fbank_kernel<1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_row = (n_frames + 16 * tile.wm - 1) / (16 * tile.wm);
  kernel<<<batch * tiles_per_row, 32 * tile.wm * tile.ns, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float4*>(bdft),
      static_cast<const float4*>(bmel), static_cast<float*>(out), n_samples,
      n_frames, tiles_per_row, frame_shift, nks, n_bins, M, use_power, use_log);
  return (int)cudaGetLastError();
}

}  // extern "C"
