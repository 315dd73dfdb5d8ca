// wav.scp -> per-utterance speaker embeddings + RTF log, with the port.
//
// The counterpart of the JAX runtime's extract_speaker_embedding: read a
// wav.scp, per utterance decode + fbank (native, host) + model forward,
// write one embedding text file per utterance, report total wall-clock
// against audio duration (real-time factor) on stderr.
//
// Two engines:
//   bridge (default) — the port's eager model through the embedded-CPython
//     bridge (speaker3d_tpu_torch/runtime_bridge.py, in libs3d_bridge.so
//     beside this binary, loaded only for this engine; model_spec is a
//     registry id or an experiment dir);
//   aot — AOTInductor packages run by libtorch (model_spec is the --aot_dir
//     of speaker3d_tpu_torch/cli/export_speaker_embedding.py; no Python).
//     The Res2 block kernel runs inside them as s3d::res2_block.
// Both run on the card unless --device cpu is given; nothing moves to the
// CPU on its own. The line "res2_block launches: F B" on stderr counts the
// kernel's float32 and bfloat16 launches of the native registration (the
// aot engine's).
//
// Usage: extract_speaker_embedding <wav.scp> <out_dir> <model_spec>
//        [--engine bridge|aot] [--device cuda|cpu]
//        [--local_model_dir DIR] [--repo_root DIR]

#include <chrono>
#include <cstdio>
#include <cstring>
#include <exception>
#include <fstream>
#include <memory>
#include <sstream>
#include <string>

#include "s3d/aoti_engine.h"
#include "s3d/chunk_plan.h"
#include "s3d/embedder.h"
#include "s3d/fbank.h"
#include "s3d/res2_op.h"
#include "s3d/wav.h"

namespace {

int Run(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: %s <wav.scp> <out_dir> <model_spec> "
                 "[--engine bridge|aot] [--device cuda|cpu] "
                 "[--local_model_dir DIR] [--repo_root DIR]\n",
                 argv[0]);
    return 1;
  }
  std::string local_model_dir = "pretrained";
  std::string repo_root = ".";
  std::string engine = "bridge";
  std::string device = "cuda";
  for (int i = 4; i < argc; ++i) {
    if (std::strcmp(argv[i], "--plugin") == 0) {
      std::fprintf(stderr,
                   "--plugin: this runtime takes no PJRT plugin; it loads "
                   "the AOTInductor packages of --aot_dir through libtorch "
                   "(--engine aot)\n");
      return 1;
    }
    if (i + 1 >= argc) continue;
    if (std::strcmp(argv[i], "--local_model_dir") == 0)
      local_model_dir = argv[i + 1];
    if (std::strcmp(argv[i], "--repo_root") == 0) repo_root = argv[i + 1];
    if (std::strcmp(argv[i], "--engine") == 0) engine = argv[i + 1];
    if (std::strcmp(argv[i], "--device") == 0) device = argv[i + 1];
  }
  if (engine != "bridge" && engine != "aot") {
    std::fprintf(stderr, "--engine must be bridge or aot, got %s\n",
                 engine.c_str());
    return 1;
  }
  if (device != "cuda" && device != "cpu") {
    std::fprintf(stderr, "--device must be cuda or cpu, got %s\n",
                 device.c_str());
    return 1;
  }

  s3d::FbankOptions opts;
  opts.mean_norm = true;
  s3d::FbankComputer fbank(opts);
  std::unique_ptr<s3d::AotiEngine> aot;
  std::unique_ptr<s3d::Embedder> bridge;
  if (engine == "aot") {
    aot.reset(new s3d::AotiEngine(argv[3], device));
  } else {
    bridge = s3d::OpenBridge(argv[3], local_model_dir, repo_root, device);
  }
  auto embed = [&](const std::vector<std::vector<float>>& feats) {
    return aot ? aot->Embed(feats) : bridge->Embed(feats);
  };

  std::ifstream scp(argv[1]);
  if (!scp) {
    std::fprintf(stderr, "cannot open %s\n", argv[1]);
    return 1;
  }

  double total_audio_s = 0.0;
  int count = 0;
  const auto t0 = std::chrono::steady_clock::now();

  std::string line;
  while (std::getline(scp, line)) {
    std::istringstream ss(line);
    std::string utt, path;
    if (!(ss >> utt >> path)) continue;
    const s3d::WavData wav = s3d::ReadWav(path);
    total_audio_s += static_cast<double>(wav.samples.size()) / wav.sample_rate;
    std::vector<float> emb;
    if (aot && !aot->bucket_samples().empty()) {
      // variable-length serving: 10 s chunks / 90 s cap / circle-pad each
      // chunk to the smallest duration bucket / mean over chunk embeddings
      // (infer_sv_batch semantics; buckets from aot.json)
      const auto plan = s3d::PlanChunks(
          static_cast<int64_t>(wav.samples.size()), aot->bucket_samples(),
          aot->max_samples() > 0 ? aot->max_samples()
                                 : static_cast<int64_t>(90) * 16000);
      if (plan.empty()) continue;
      for (const auto& c : plan) {
        const auto piece = s3d::CirclePad(wav.samples.data() + c.start,
                                          c.length, c.padded);
        const auto e = embed(fbank.Compute(piece));
        if (emb.empty()) emb.assign(e.size(), 0.0f);
        for (size_t i = 0; i < e.size(); ++i) emb[i] += e[i];
      }
      for (auto& v : emb) v /= static_cast<float>(plan.size());
    } else {
      const auto feats = fbank.Compute(wav.samples);
      if (feats.empty()) {
        // no fbank frame to embed (extract --mode exact skips it too)
        std::fprintf(stderr,
                     "[WARNING] skipping %s: %zu samples, shorter than one "
                     "%d-sample frame\n",
                     utt.c_str(), wav.samples.size(), opts.FrameLength());
        continue;
      }
      emb = embed(feats);
    }

    const std::string out_path = std::string(argv[2]) + "/" + utt + ".emb";
    std::FILE* f = std::fopen(out_path.c_str(), "w");
    if (!f) {
      std::perror("fopen");
      return 1;
    }
    for (size_t i = 0; i < emb.size(); ++i)
      std::fprintf(f, "%s%.6f", i ? " " : "", emb[i]);
    std::fprintf(f, "\n");
    std::fclose(f);
    ++count;
  }

  const double elapsed =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  std::fprintf(stderr,
               "processed %d utts, %.2f s audio in %.2f s wall "
               "(RTF %.4f, %.1fx realtime)\n",
               count, total_audio_s, elapsed, elapsed / total_audio_s,
               total_audio_s / elapsed);
  std::fprintf(stderr, "res2_block launches: %lld %lld\n",
               static_cast<long long>(s3d::Res2Launches(false)),
               static_cast<long long>(s3d::Res2Launches(true)));
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Run(argc, argv);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "extract_speaker_embedding: %s\n", e.what());
    return 1;
  }
}
