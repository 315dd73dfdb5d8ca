// wav -> log-mel fbank features, written as text (one frame per line).
// Mirrors the reference CLI (reference: runtime/onnxruntime/bin/
// make_fbank_feature.cpp).
//
// Usage: make_fbank_feature <wav> <out.txt> [--mean_norm]

#include <cstdio>
#include <cstring>
#include <string>

#include "s3d/fbank.h"
#include "s3d/wav.h"

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <wav> <out.txt> [--mean_norm]\n", argv[0]);
    return 1;
  }
  s3d::FbankOptions opts;
  for (int i = 3; i < argc; ++i)
    if (std::strcmp(argv[i], "--mean_norm") == 0) opts.mean_norm = true;

  const s3d::WavData wav = s3d::ReadWav(argv[1]);
  opts.sample_rate = wav.sample_rate;
  s3d::FbankComputer fbank(opts);
  const auto feats = fbank.Compute(wav.samples);

  std::FILE* f = std::fopen(argv[2], "w");
  if (!f) {
    std::perror("fopen");
    return 1;
  }
  for (const auto& row : feats) {
    for (size_t i = 0; i < row.size(); ++i)
      std::fprintf(f, "%s%.6f", i ? " " : "", row[i]);
    std::fprintf(f, "\n");
  }
  std::fclose(f);
  std::fprintf(stderr, "wrote %zu frames x %d bins\n", feats.size(),
               opts.num_mel_bins);
  return 0;
}
