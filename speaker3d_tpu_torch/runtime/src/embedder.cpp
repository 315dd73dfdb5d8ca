#include "s3d/embedder.h"

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <stdexcept>
#include <string>

// The interpreter that built this binary (runtime/build.py passes its
// sys.executable): the embedded one takes its prefix, and so its
// site-packages, from it. SPEAKER3D_PYTHON overrides it.
#ifndef S3D_PYTHON_EXECUTABLE
#define S3D_PYTHON_EXECUTABLE ""
#endif

namespace s3d {
namespace {

void ThrowPyError(const std::string& where) {
  PyErr_Print();
  throw std::runtime_error("python error in " + where);
}

void StartPython() {
  if (Py_IsInitialized()) return;
  const char* env = std::getenv("SPEAKER3D_PYTHON");
  const std::string exe = env ? env : S3D_PYTHON_EXECUTABLE;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  PyStatus status = PyStatus_Ok();
  if (!exe.empty())
    status = PyConfig_SetBytesString(&config, &config.program_name,
                                     exe.c_str());
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status))
    throw std::runtime_error(std::string("cannot start Python: ") +
                             (status.err_msg ? status.err_msg : "?"));
}

class PythonEmbedder : public Embedder {
 public:
  PythonEmbedder(const std::string& model_spec,
                 const std::string& local_model_dir,
                 const std::string& repo_root, const std::string& device);
  ~PythonEmbedder() override;
  std::vector<float> Embed(
      const std::vector<std::vector<float>>& feats) override;

 private:
  PyObject* embed_fn_ = nullptr;
};

PythonEmbedder::PythonEmbedder(const std::string& model_spec,
                               const std::string& local_model_dir,
                               const std::string& repo_root,
                               const std::string& device) {
  StartPython();

  // Make the repo importable inside the embedded interpreter.
  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  PyObject* root = PyUnicode_FromString(repo_root.c_str());
  PyList_Insert(sys_path, 0, root);
  Py_DECREF(root);

  PyObject* mod = PyImport_ImportModule("speaker3d_tpu_torch.runtime_bridge");
  if (!mod) ThrowPyError("import runtime_bridge");
  PyObject* ret =
      PyObject_CallMethod(mod, "init", "ssiss", model_spec.c_str(),
                          local_model_dir.c_str(), 80, "high", device.c_str());
  if (!ret) ThrowPyError("runtime_bridge.init");
  Py_DECREF(ret);
  embed_fn_ = PyObject_GetAttrString(mod, "embed");
  Py_DECREF(mod);
  if (!embed_fn_) ThrowPyError("runtime_bridge.embed lookup");
}

PythonEmbedder::~PythonEmbedder() { Py_XDECREF(embed_fn_); }

std::vector<float> PythonEmbedder::Embed(
    const std::vector<std::vector<float>>& feats) {
  const Py_ssize_t num_frames = static_cast<Py_ssize_t>(feats.size());
  const Py_ssize_t feat_dim =
      num_frames > 0 ? static_cast<Py_ssize_t>(feats[0].size()) : 0;
  std::vector<float> flat;
  flat.reserve(num_frames * feat_dim);
  for (const auto& row : feats) flat.insert(flat.end(), row.begin(), row.end());

  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(flat.data()),
      static_cast<Py_ssize_t>(flat.size() * sizeof(float)));
  PyObject* out =
      PyObject_CallFunction(embed_fn_, "Onn", bytes, num_frames, feat_dim);
  Py_DECREF(bytes);
  if (!out) ThrowPyError("runtime_bridge.embed");

  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(out, &buf, &len) != 0)
    ThrowPyError("embed result decode");
  std::vector<float> emb(len / sizeof(float));
  std::memcpy(emb.data(), buf, static_cast<size_t>(len));
  Py_DECREF(out);
  return emb;
}

}  // namespace
}  // namespace s3d

extern "C" s3d::Embedder* s3d_open_bridge(const char* model_spec,
                                          const char* local_model_dir,
                                          const char* repo_root,
                                          const char* device, char* err,
                                          int err_len) {
  try {
    return new s3d::PythonEmbedder(model_spec, local_model_dir, repo_root,
                                   device);
  } catch (const std::exception& e) {
    std::snprintf(err, static_cast<size_t>(err_len), "%s", e.what());
    return nullptr;
  }
}
