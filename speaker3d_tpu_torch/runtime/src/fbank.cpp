#include "s3d/fbank.h"

#include <algorithm>
#include <cmath>
#include <complex>
#include <limits>
#include <stdexcept>

namespace s3d {
namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr float kEps = std::numeric_limits<float>::epsilon();

double MelScale(double freq) { return 1127.0 * std::log1p(freq / 700.0); }

// Iterative radix-2 complex FFT (decimation in time), in-place.
void Fft(std::vector<std::complex<double>>& a) {
  const size_t n = a.size();
  // bit-reversal permutation
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * kPi / static_cast<double>(len);
    const std::complex<double> wlen(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      std::complex<double> w(1.0, 0.0);
      for (size_t k = 0; k < len / 2; ++k) {
        const std::complex<double> u = a[i + k];
        const std::complex<double> v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
}

}  // namespace

int FbankOptions::PaddedWindowSize() const {
  int n = FrameLength();
  if (!round_to_power_of_two) return n;
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

int FbankOptions::NumFrames(size_t num_samples) const {
  const int len = FrameLength();
  if (static_cast<int>(num_samples) < len) return 0;
  return 1 + (static_cast<int>(num_samples) - len) / FrameShift();
}

FbankComputer::FbankComputer(const FbankOptions& opts) : opts_(opts) {
  const int n = opts_.FrameLength();
  window_.resize(n);
  const double a = 2.0 * kPi / (n - 1);
  for (int i = 0; i < n; ++i) {
    if (opts_.window_type == "povey") {
      window_[i] = static_cast<float>(
          std::pow(0.5 - 0.5 * std::cos(a * i), 0.85));
    } else if (opts_.window_type == "hamming") {
      window_[i] = static_cast<float>(0.54 - 0.46 * std::cos(a * i));
    } else if (opts_.window_type == "hanning") {
      window_[i] = static_cast<float>(0.5 - 0.5 * std::cos(a * i));
    } else if (opts_.window_type == "rectangular") {
      window_[i] = 1.0f;
    } else {
      throw std::invalid_argument("unknown window type " + opts_.window_type);
    }
  }

  // Triangular mel filterbank over fft bins 0..nfft/2-1 (Nyquist excluded),
  // Kaldi mel domain construction.
  const int nfft = opts_.PaddedWindowSize();
  const int num_fft_bins = nfft / 2;
  const double nyquist = 0.5 * opts_.sample_rate;
  const double high =
      opts_.high_freq > 0 ? opts_.high_freq : nyquist + opts_.high_freq;
  const double mel_low = MelScale(opts_.low_freq);
  const double mel_high = MelScale(high);
  const double delta = (mel_high - mel_low) / (opts_.num_mel_bins + 1);
  const double bin_width = static_cast<double>(opts_.sample_rate) / nfft;

  mel_banks_.assign(opts_.num_mel_bins,
                    std::vector<float>(num_fft_bins + 1, 0.0f));
  for (int m = 0; m < opts_.num_mel_bins; ++m) {
    const double left = mel_low + m * delta;
    const double center = left + delta;
    const double right = center + delta;
    for (int i = 0; i < num_fft_bins; ++i) {
      const double mel = MelScale(i * bin_width);
      const double up = (mel - left) / delta;
      const double down = (right - mel) / delta;
      const double w = std::max(0.0, std::min(up, down));
      mel_banks_[m][i] = static_cast<float>(w);
    }
  }
}

std::vector<std::vector<float>> FbankComputer::Compute(
    const std::vector<float>& wave) const {
  const int frame_len = opts_.FrameLength();
  const int shift = opts_.FrameShift();
  const int nfft = opts_.PaddedWindowSize();
  const int n_bins = nfft / 2 + 1;
  const int num_frames = opts_.NumFrames(wave.size());

  std::vector<std::vector<float>> feats(
      num_frames, std::vector<float>(opts_.num_mel_bins, 0.0f));
  std::vector<double> frame(frame_len);
  std::vector<std::complex<double>> buf(nfft);
  std::vector<double> power(n_bins);

  for (int f = 0; f < num_frames; ++f) {
    const int start = f * shift;
    for (int i = 0; i < frame_len; ++i) frame[i] = wave[start + i];

    if (opts_.remove_dc_offset) {
      double mean = 0.0;
      for (double v : frame) mean += v;
      mean /= frame_len;
      for (double& v : frame) v -= mean;
    }
    if (opts_.preemphasis != 0.0f) {
      for (int i = frame_len - 1; i > 0; --i)
        frame[i] -= opts_.preemphasis * frame[i - 1];
      frame[0] -= opts_.preemphasis * frame[0];
    }
    for (int i = 0; i < frame_len; ++i) frame[i] *= window_[i];

    std::fill(buf.begin(), buf.end(), std::complex<double>(0.0, 0.0));
    for (int i = 0; i < frame_len; ++i) buf[i] = frame[i];
    Fft(buf);
    for (int k = 0; k < n_bins; ++k) {
      power[k] = std::norm(buf[k]);
      if (!opts_.use_power) power[k] = std::sqrt(power[k]);
    }

    for (int m = 0; m < opts_.num_mel_bins; ++m) {
      double e = 0.0;
      const auto& bank = mel_banks_[m];
      for (int k = 0; k < n_bins; ++k) e += power[k] * bank[k];
      if (opts_.use_log_fbank)
        e = std::log(std::max(e, static_cast<double>(kEps)));
      feats[f][m] = static_cast<float>(e);
    }
  }

  if (opts_.mean_norm && num_frames > 0) {
    std::vector<double> mean(opts_.num_mel_bins, 0.0);
    for (const auto& row : feats)
      for (int m = 0; m < opts_.num_mel_bins; ++m) mean[m] += row[m];
    for (double& v : mean) v /= num_frames;
    for (auto& row : feats)
      for (int m = 0; m < opts_.num_mel_bins; ++m)
        row[m] -= static_cast<float>(mean[m]);
  }
  return feats;
}

}  // namespace s3d
