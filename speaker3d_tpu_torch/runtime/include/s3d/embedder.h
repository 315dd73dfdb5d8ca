// Speaker-embedding model execution through an embedded CPython interpreter
// that calls speaker3d_tpu_torch/runtime_bridge.py (init, embed): the
// native layer reads the wav and computes the fbank, the port's eager model
// runs the embedding, on the card unless device is "cpu".
//
// The interpreter lives in libs3d_bridge.so (src/embedder.cpp, linked
// against libpython), which OpenBridge loads from beside the executable
// only when the bridge engine is asked for: the aot engine's process holds
// no Python.
#pragma once

#include <memory>
#include <string>
#include <vector>

namespace s3d {

class Embedder {
 public:
  virtual ~Embedder() = default;
  // feats: [num_frames][feat_dim] -> embedding vector.
  virtual std::vector<float> Embed(
      const std::vector<std::vector<float>>& feats) = 0;
};

// model_spec: registry model id or experiment dir; repo_root is put first
// on the interpreter's sys.path. Throws std::runtime_error.
std::unique_ptr<Embedder> OpenBridge(const std::string& model_spec,
                                     const std::string& local_model_dir,
                                     const std::string& repo_root,
                                     const std::string& device);

}  // namespace s3d

// The entry point of libs3d_bridge.so: a new Embedder, or nullptr with the
// reason in err (at most err_len bytes, terminated).
extern "C" s3d::Embedder* s3d_open_bridge(const char* model_spec,
                                          const char* local_model_dir,
                                          const char* repo_root,
                                          const char* device, char* err,
                                          int err_len);
