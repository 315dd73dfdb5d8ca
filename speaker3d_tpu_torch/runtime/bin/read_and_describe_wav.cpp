// Describe a WAV file (rate, channels, duration, peak).
// (reference: runtime/onnxruntime/bin/read_and_describe_wav.cpp)

#include <algorithm>
#include <cmath>
#include <cstdio>

#include "s3d/wav.h"

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <wav>\n", argv[0]);
    return 1;
  }
  const s3d::WavData wav = s3d::ReadWav(argv[1]);
  float peak = 0.0f;
  double sumsq = 0.0;
  for (float v : wav.samples) {
    peak = std::max(peak, std::fabs(v));
    sumsq += static_cast<double>(v) * v;
  }
  std::printf("sample_rate: %d\nchannels: %d\nsamples: %zu\n"
              "duration_s: %.3f\npeak: %.4f\nrms: %.5f\n",
              wav.sample_rate, wav.num_channels, wav.samples.size(),
              static_cast<double>(wav.samples.size()) / wav.sample_rate, peak,
              std::sqrt(sumsq / std::max<size_t>(wav.samples.size(), 1)));
  return 0;
}
