#include "s3d/aoti_engine.h"

#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <stdexcept>
#include <utility>

#include "s3d/res2_op.h"

namespace s3d {
namespace {

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// The value of "key" in a flat JSON object, unquoted ("" when absent); the
// first occurrence wins (the JAX runtime's pjrt_engine.cpp reads aot.json
// the same way).
std::string JsonValue(const std::string& js, const std::string& key) {
  auto pos = js.find("\"" + key + "\"");
  if (pos == std::string::npos) return "";
  pos = js.find(':', pos);
  if (pos == std::string::npos) return "";
  ++pos;
  while (pos < js.size() && (js[pos] == ' ' || js[pos] == '"')) ++pos;
  size_t end = pos;
  while (end < js.size() && js[end] != ',' && js[end] != '}' &&
         js[end] != '"' && js[end] != '\n')
    ++end;
  return js.substr(pos, end - pos);
}

}  // namespace

struct AotiEngine::Impl {
  c10::Device device{c10::kCPU};
  int feat_dim = 0;
  // (frames, package), ascending by frames
  std::vector<std::pair<int, std::unique_ptr<
                                 torch::inductor::AOTIModelPackageLoader>>>
      packages;
};

AotiEngine::AotiEngine(const std::string& model_dir,
                       const std::string& device)
    : impl_(new Impl) {
  RegisterRes2Op();
  const std::string meta = ReadFile(model_dir + "/aot.json");
  if (device != "cuda" && device != "cpu")
    throw std::runtime_error("--device must be cuda or cpu, got " + device);
  const std::string built_for = JsonValue(meta, "device");
  if (built_for != device)
    throw std::runtime_error("the packages in " + model_dir +
                             " were compiled for device '" + built_for +
                             "', not '" + device + "'");
  if (device == "cuda" && !at::hasCUDA())
    throw std::runtime_error("--device cuda: no CUDA device or no CUDA "
                             "build of libtorch; pass --device cpu with a "
                             "package compiled for the CPU");
  impl_->device = c10::Device(device == "cuda" ? c10::kCUDA : c10::kCPU,
                              device == "cuda" ? 0 : -1);

  // "precision": "high" / "float32" / "highest" keep full float32 products
  // (TF32 off in cuDNN and cuBLAS); null allows TF32, as
  // eval/embedding.py::matmul_precision
  const std::string precision = JsonValue(meta, "precision");
  const bool tf32 = precision == "null";
  if (!tf32 && precision != "high" && precision != "float32" &&
      precision != "highest")
    throw std::runtime_error("aot.json: unknown precision '" + precision +
                             "'");
  at::globalContext().setAllowTF32CuDNN(tf32);
  at::globalContext().setAllowTF32CuBLAS(tf32);

  // "buckets": [{"seconds":..,"samples":N,"frames":F},..]; the top-level
  // keys are read from a copy with the array blanked out, since each bucket
  // repeats "frames"
  std::string top = meta;
  std::vector<int> frames;
  const auto bpos = meta.find("\"buckets\"");
  if (bpos != std::string::npos) {
    const auto open = meta.find('[', bpos), close = meta.find(']', bpos);
    if (open == std::string::npos || close == std::string::npos)
      throw std::runtime_error("aot.json: malformed buckets");
    const std::string arr = meta.substr(open, close - open);
    for (size_t p = arr.find("\"samples\""); p != std::string::npos;
         p = arr.find("\"samples\"", p + 1)) {
      bucket_samples_.push_back(std::stoll(JsonValue(arr.substr(p), "samples")));
      frames.push_back(std::stoi(JsonValue(arr.substr(p), "frames")));
    }
    top.replace(open, close - open + 1, std::string(close - open + 1, ' '));
    max_samples_ = static_cast<int64_t>(
        std::stod(JsonValue(meta, "max_seconds")) *
        std::stod(JsonValue(meta, "sample_rate")));
  }
  impl_->feat_dim = std::stoi(JsonValue(top, "feat_dim"));
  auto load = [&](int f, const std::string& stem) {
    const auto t0 = std::chrono::steady_clock::now();
    impl_->packages.emplace_back(
        f, std::make_unique<torch::inductor::AOTIModelPackageLoader>(
               model_dir + "/" + stem + ".pt2", "model", false, 1,
               impl_->device.index()));
    std::fprintf(stderr, "[aoti_engine] %s.pt2 (%d frames) loaded in %.1f s\n",
                 stem.c_str(), f,
                 std::chrono::duration<double>(
                     std::chrono::steady_clock::now() - t0)
                     .count());
  };
  if (frames.empty()) {
    load(std::stoi(JsonValue(top, "frames")), "model");
  } else {
    for (int f : frames) load(f, "model_f" + std::to_string(f));
  }
}

AotiEngine::~AotiEngine() = default;

std::vector<float> AotiEngine::Embed(
    const std::vector<std::vector<float>>& feats) {
  if (feats.empty()) throw std::runtime_error("no feature frames to embed");
  auto* chosen = &impl_->packages.back();
  for (auto& p : impl_->packages) {
    if (p.first >= static_cast<int>(feats.size())) {
      chosen = &p;
      break;
    }
  }
  const int frames = chosen->first, dim = impl_->feat_dim;
  auto host = at::empty({1, frames, dim}, at::kFloat);
  float* dst = host.data_ptr<float>();
  for (int t = 0; t < frames; ++t) {
    const auto& row = feats[std::min<size_t>(t, feats.size() - 1)];
    if (static_cast<int>(row.size()) != dim)
      throw std::runtime_error("feature width differs from aot.json's");
    std::memcpy(dst + static_cast<size_t>(t) * dim, row.data(),
                sizeof(float) * dim);
  }
  const auto outs = chosen->second->run({host.to(impl_->device)});
  const auto emb = outs.at(0).to(at::kCPU).to(at::kFloat).contiguous();
  return std::vector<float>(emb.data_ptr<float>(),
                            emb.data_ptr<float>() + emb.numel());
}

}  // namespace s3d
