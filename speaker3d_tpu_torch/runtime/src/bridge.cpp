// OpenBridge (s3d/embedder.h): load libs3d_bridge.so, and the libpython it
// embeds with its symbols global (Python's extension modules take them from
// the process), from beside the running executable.

#include <dlfcn.h>
#include <unistd.h>

#include <stdexcept>
#include <string>

#include "s3d/embedder.h"

// The libpython of the interpreter that built this binary
// (runtime/build.py).
#ifndef S3D_LIBPYTHON
#define S3D_LIBPYTHON "libpython3.so"
#endif

namespace s3d {
namespace {

std::string ExecutableDir() {
  char buf[4096];
  const ssize_t n = readlink("/proc/self/exe", buf, sizeof(buf) - 1);
  if (n <= 0) throw std::runtime_error("cannot resolve /proc/self/exe");
  const std::string exe(buf, static_cast<size_t>(n));
  return exe.substr(0, exe.rfind('/'));
}

}  // namespace

std::unique_ptr<Embedder> OpenBridge(const std::string& model_spec,
                                     const std::string& local_model_dir,
                                     const std::string& repo_root,
                                     const std::string& device) {
  if (!dlopen(S3D_LIBPYTHON, RTLD_NOW | RTLD_GLOBAL))
    throw std::runtime_error(std::string("cannot load ") + S3D_LIBPYTHON +
                             ": " + dlerror());
  const std::string lib = ExecutableDir() + "/libs3d_bridge.so";
  void* handle = dlopen(lib.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (!handle)
    throw std::runtime_error("cannot load " + lib + ": " + dlerror());
  auto open = reinterpret_cast<decltype(&s3d_open_bridge)>(
      dlsym(handle, "s3d_open_bridge"));
  if (!open) throw std::runtime_error(lib + " has no s3d_open_bridge");
  char err[1024] = "";
  Embedder* embedder = open(model_spec.c_str(), local_model_dir.c_str(),
                            repo_root.c_str(), device.c_str(), err,
                            static_cast<int>(sizeof(err)));
  if (!embedder) throw std::runtime_error(err);
  return std::unique_ptr<Embedder>(embedder);
}

}  // namespace s3d
