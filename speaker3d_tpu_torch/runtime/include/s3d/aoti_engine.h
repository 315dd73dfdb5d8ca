// Speaker-embedding execution of AOTInductor packages through libtorch, with
// no Python: the port's counterpart of the JAX runtime's PJRT engine.
//
// model_dir is speaker3d_tpu_torch/cli/export_speaker_embedding.py's
// --aot_dir: aot.json and model.pt2, or one model_f<frames>.pt2 per
// duration bucket. Each package is loaded once
// (torch::inductor::AOTIModelPackageLoader) and runs [1, frames, feat_dim]
// float32 -> [1, emb_dim] float32. The engine registers s3d::res2_block
// (s3d/res2_op.h), which the packages of the ERes2Net models call, and sets
// the process's TF32 flags from aot.json's "precision" as the port's
// eval/embedding.py::matmul_precision does.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace s3d {

class AotiEngine {
 public:
  // device: "cuda" or "cpu"; it must be the device the packages were
  // compiled for (aot.json's "device"). Throws std::runtime_error.
  AotiEngine(const std::string& model_dir, const std::string& device);
  ~AotiEngine();

  // feats [num_frames][feat_dim], run on the package with the smallest
  // frame count >= num_frames (the last frame repeated to it), or the
  // largest one with the frames cut to it; returns the embedding.
  std::vector<float> Embed(const std::vector<std::vector<float>>& feats);

  // variable-length serving meta (empty when the artifact is single-shape)
  const std::vector<int64_t>& bucket_samples() const {
    return bucket_samples_;
  }
  int64_t max_samples() const { return max_samples_; }

 private:
  struct Impl;
  std::unique_ptr<Impl> impl_;
  std::vector<int64_t> bucket_samples_;
  int64_t max_samples_ = 0;
};

}  // namespace s3d
