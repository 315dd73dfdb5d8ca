// Native Kaldi-compatible log-mel filterbank frontend.
//
// Behavioral contract: same spec as the port's Python frontend
// (speaker3d_tpu_torch/ops/fbank.py) and torchaudio.compliance.kaldi.fbank with
// dither=0 — 25ms/10ms framing (snip_edges), DC removal, pre-emphasis 0.97,
// povey window, power spectrum via radix-2 FFT (padded to 512), 80
// triangular mel bins (Kaldi mel scale, low 20 Hz, high = Nyquist), natural
// log with float-eps floor, optional per-utterance mean normalization.
// Mirrors the role of the reference's C++ frontend
// (reference: runtime/onnxruntime/feature/feature_common.cpp:39-162).
#pragma once

#include <cstddef>
#include <string>
#include <vector>

namespace s3d {

struct FbankOptions {
  int sample_rate = 16000;
  float frame_length_ms = 25.0f;
  float frame_shift_ms = 10.0f;
  int num_mel_bins = 80;
  float low_freq = 20.0f;
  float high_freq = 0.0f;  // <= 0: offset from Nyquist
  float preemphasis = 0.97f;
  bool remove_dc_offset = true;
  std::string window_type = "povey";  // povey|hamming|hanning|rectangular
  bool round_to_power_of_two = true;
  bool use_power = true;
  bool use_log_fbank = true;
  bool mean_norm = false;

  int FrameLength() const {
    return static_cast<int>(sample_rate * frame_length_ms / 1000.0f);
  }
  int FrameShift() const {
    return static_cast<int>(sample_rate * frame_shift_ms / 1000.0f);
  }
  int PaddedWindowSize() const;
  int NumFrames(size_t num_samples) const;
};

class FbankComputer {
 public:
  explicit FbankComputer(const FbankOptions& opts);

  // wave: float samples (any scale; log-mel is shift-invariant after
  // mean_norm). Returns num_frames x num_mel_bins, row-major.
  std::vector<std::vector<float>> Compute(const std::vector<float>& wave) const;

  const FbankOptions& opts() const { return opts_; }

 private:
  FbankOptions opts_;
  std::vector<float> window_;                 // [frame_length]
  std::vector<std::vector<float>> mel_banks_; // [num_mel_bins][nfft/2+1]
  std::vector<float> fft_twiddle_;            // sin/cos tables
  std::vector<int> bit_reverse_;
};

}  // namespace s3d
