#include "s3d/wav.h"

#include <cstring>
#include <fstream>
#include <stdexcept>

namespace s3d {
namespace {

struct ChunkHeader {
  char id[4];
  uint32_t size;
};

uint32_t ReadU32(std::ifstream& f) {
  uint32_t v = 0;
  f.read(reinterpret_cast<char*>(&v), 4);
  return v;
}

uint16_t ReadU16(std::ifstream& f) {
  uint16_t v = 0;
  f.read(reinterpret_cast<char*>(&v), 2);
  return v;
}

}  // namespace

WavData ReadWav(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);

  char riff[4];
  f.read(riff, 4);
  if (std::strncmp(riff, "RIFF", 4) != 0)
    throw std::runtime_error(path + ": not a RIFF file");
  ReadU32(f);  // total size
  char wave[4];
  f.read(wave, 4);
  if (std::strncmp(wave, "WAVE", 4) != 0)
    throw std::runtime_error(path + ": not a WAVE file");

  WavData out;
  uint16_t bits_per_sample = 0;
  uint16_t audio_format = 0;
  bool got_fmt = false;

  while (f) {
    ChunkHeader h;
    f.read(h.id, 4);
    h.size = ReadU32(f);
    if (!f) break;
    if (std::strncmp(h.id, "fmt ", 4) == 0) {
      audio_format = ReadU16(f);
      out.num_channels = ReadU16(f);
      out.sample_rate = static_cast<int>(ReadU32(f));
      ReadU32(f);  // byte rate
      ReadU16(f);  // block align
      bits_per_sample = ReadU16(f);
      if (h.size > 16) f.seekg(h.size - 16, std::ios::cur);
      got_fmt = true;
    } else if (std::strncmp(h.id, "data", 4) == 0) {
      if (!got_fmt) throw std::runtime_error(path + ": data before fmt");
      if (audio_format != 1 || bits_per_sample != 16)
        throw std::runtime_error(path + ": only 16-bit PCM supported");
      const size_t n_samples = h.size / 2;
      std::vector<int16_t> raw(n_samples);
      f.read(reinterpret_cast<char*>(raw.data()),
             static_cast<std::streamsize>(h.size));
      const size_t frames = n_samples / out.num_channels;
      out.samples.resize(frames);
      for (size_t i = 0; i < frames; ++i) {
        double acc = 0.0;
        for (int c = 0; c < out.num_channels; ++c)
          acc += raw[i * out.num_channels + c] / 32768.0;
        out.samples[i] = static_cast<float>(acc / out.num_channels);
      }
      return out;
    } else {
      f.seekg(h.size + (h.size & 1), std::ios::cur);
    }
  }
  throw std::runtime_error(path + ": no data chunk found");
}

}  // namespace s3d
