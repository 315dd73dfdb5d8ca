// Minimal RIFF/WAVE reader: 16-bit PCM -> float [-1, 1].
// Mirrors the role of the reference's native wav reader
// (reference: runtime/onnxruntime/utils/wav_reader.{h,cpp}).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace s3d {

struct WavData {
  int sample_rate = 0;
  int num_channels = 0;
  // mono samples (channel mean), float32 in [-1, 1]
  std::vector<float> samples;
};

// Throws std::runtime_error on malformed input.
WavData ReadWav(const std::string& path);

}  // namespace s3d
