// Kaldi log-mel filterbank for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel speaker3d_tpu/ops/pallas/fbank_kernel.py
// (_fbank_kernel, launched by pallas_fbank -> _build -> pl.pallas_call).
// Same function, per frame of frame_len samples at stride frame_shift:
//
//   y     = frame @ B            B [frame_len, 2R]: DC removal, pre-emphasis,
//                                window and the padded rDFT folded into one
//                                matrix (ops/fbank.py analysis_matrix)
//   p[k]  = y_re[k]^2 + y_im[k]^2   (sqrt of it when use_power == 0)
//   out   = log(max(p @ mel, FLT_EPSILON))   mel [R, M]   (no log when
//                                            use_log == 0)
//
// What bounds it on the H100: the two contractions, ~4.3 GFLOP for a batch of
// 64 x 1.5 s chunks against ~10 MB moved, so it sits far above the fp32
// ridge; it is bound by fp32 FMA throughput (no tensor cores: the path's
// numerics are fp32 HIGHEST, which TF32 would break).
//
// Design:
// - One block per (tile of TILE_T frames, batch row). The block copies the
//   contiguous stretch of waveform its frames cover into shared memory once
//   (coalesced) and reads every frame from there at stride frame_shift: no
//   frames tensor is built in device memory (the TPU kernel had XLA frame the
//   waveform outside because Mosaic cannot lower strided slices).
// - Stage 1 streams B through shared memory in KT-row slabs; each thread holds
//   FPT frames x BPT bins of (re, im) accumulators in registers, so the
//   power spectrum is formed in registers and written to shared memory
//   without the rDFT output ever leaving the SM.
// - Only bins 0..NB-1 (NB = 256 of R = 257) are computed: the Nyquist row of
//   the Kaldi mel matrix is zero (mel_banks builds bins 0..N/2-1), which the
//   Python wrapper checks before it launches.
// - Stage 2 multiplies the power tile by mel (read through L1/L2, 80 KB) and
//   applies the log; frames past the end of the waveform (the ragged last
//   tile) are masked on store.
//
// Plain C interface (bound with ctypes); every entry point returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int TILE_T = 32;    // frames per block
constexpr int NB = 256;       // rDFT bins computed (Nyquist bin skipped)
constexpr int KT = 16;        // rows of B per shared-memory slab
constexpr int THREADS = 256;
constexpr int BIN_THREADS = 64;               // threads along bins
constexpr int BPT = NB / BIN_THREADS;         // bins per thread (4)
constexpr int FRAME_GROUPS = THREADS / BIN_THREADS;  // 4
constexpr int FPT = TILE_T / FRAME_GROUPS;    // frames per thread (8)
constexpr int P_LD = NB + 1;                  // padded power-tile row

__global__ void __launch_bounds__(THREADS)
fbank_kernel(const float* __restrict__ wav, const float* __restrict__ B,
             const float* __restrict__ mel, float* __restrict__ out,
             int n_samples, int n_frames, int frame_len, int frame_shift,
             int R, int M, int use_power, int use_log) {
  extern __shared__ float smem[];
  const int seg_len = (TILE_T - 1) * frame_shift + frame_len + KT;
  float* seg = smem;                       // [seg_len]
  float* bs = seg + seg_len;               // [KT][2*NB]
  float* pw = bs + KT * 2 * NB;            // [TILE_T][P_LD]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE_T;
  const float* w = wav + (size_t)b * n_samples;
  const long s0 = (long)t0 * frame_shift;

  for (int i = tid; i < seg_len; i += THREADS) {
    const long s = s0 + i;
    seg[i] = s < n_samples ? w[s] : 0.f;
  }

  const int tx = tid % BIN_THREADS;
  const int fg = tid / BIN_THREADS;
  float re[FPT][BPT], im[FPT][BPT];
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int q = 0; q < BPT; ++q) re[i][q] = im[i][q] = 0.f;

  for (int j0 = 0; j0 < frame_len; j0 += KT) {
    __syncthreads();  // seg loaded / previous slab consumed
    for (int i = tid; i < KT * 2 * NB; i += THREADS) {
      const int jj = i / (2 * NB), c = i % (2 * NB);
      const int j = j0 + jj;
      const int col = c < NB ? c : R + (c - NB);
      bs[i] = j < frame_len ? B[(size_t)j * 2 * R + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < KT; ++jj) {
      float a[FPT], br[BPT], bi[BPT];
#pragma unroll
      for (int i = 0; i < FPT; ++i)
        a[i] = seg[(fg * FPT + i) * frame_shift + j0 + jj];
#pragma unroll
      for (int q = 0; q < BPT; ++q) {
        br[q] = bs[jj * 2 * NB + tx + q * BIN_THREADS];
        bi[q] = bs[jj * 2 * NB + NB + tx + q * BIN_THREADS];
      }
#pragma unroll
      for (int i = 0; i < FPT; ++i)
#pragma unroll
        for (int q = 0; q < BPT; ++q) {
          re[i][q] = fmaf(a[i], br[q], re[i][q]);
          im[i][q] = fmaf(a[i], bi[q], im[i][q]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int q = 0; q < BPT; ++q) {
      float p = re[i][q] * re[i][q] + im[i][q] * im[i][q];
      if (!use_power) p = sqrtf(p);
      pw[(fg * FPT + i) * P_LD + tx + q * BIN_THREADS] = p;
    }
  __syncthreads();

  // stage 2: [TILE_T, NB] @ mel[NB, M] -> log; consecutive threads take
  // consecutive mel bins of one frame (mel loads coalesce, pw broadcasts)
  for (int o = tid; o < TILE_T * M; o += THREADS) {
    const int f = o / M, m = o % M;
    const int t = t0 + f;
    if (t >= n_frames) continue;
    const float* prow = pw + f * P_LD;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < NB; ++k) acc = fmaf(prow[k], __ldg(mel + k * M + m), acc);
    if (use_log) acc = logf(fmaxf(acc, FLT_EPSILON));
    out[((size_t)b * n_frames + t) * M + m] = acc;
  }
}

}  // namespace

extern "C" {

const char* s3d_errstr(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared-memory bytes one block needs, for the wrapper's check.
int s3d_fbank_smem_bytes(int frame_len, int frame_shift) {
  const int seg_len = (TILE_T - 1) * frame_shift + frame_len + KT;
  return (int)sizeof(float) * (seg_len + KT * 2 * NB + TILE_T * P_LD);
}

// wav [batch, n_samples], B [frame_len, 2R], mel [R, M], out [batch,
// n_frames, M]; all fp32, contiguous, on the device of `stream`.
int s3d_fbank_f32(const void* wav, const void* B, const void* mel, void* out,
                  int batch, int n_samples, int n_frames, int frame_len,
                  int frame_shift, int R, int M, int use_power, int use_log,
                  void* stream) {
  const int smem = s3d_fbank_smem_bytes(frame_len, frame_shift);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + TILE_T - 1) / TILE_T, batch);
  fbank_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(B),
      static_cast<const float*>(mel), static_cast<float*>(out), n_samples,
      n_frames, frame_len, frame_shift, R, M, use_power, use_log);
  return (int)cudaGetLastError();
}

}  // extern "C"
