#include "s3d/res2_op.h"

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/library.h>

#include <atomic>
#include <memory>
#include <mutex>
#include <sstream>

#ifdef S3D_WITH_CUDA
#include <c10/cuda/CUDAStream.h>

extern "C" {
const char* s3d_errstr(int code);
int s3d_res2_block_f32(const void* x, const void* w1, const void* b1,
                       const void* wc1, const void* bc1, const void* wc2,
                       const void* bc2, const void* w3, const void* b3,
                       const void* wsc, void* out, int batch, int cin, int w,
                       int cout, int fin, int tin, int stride, void* stream);
int s3d_res2_block_bf16(const void* x, const void* w1, const void* b1,
                        const void* wc1, const void* bc1, const void* wc2,
                        const void* bc2, const void* w3, const void* b3,
                        const void* wsc, void* out, int batch, int cin, int w,
                        int cout, int fin, int tin, int stride, void* stream);
}
#endif

namespace s3d {
namespace {

// The same string as SCHEMA in ops/kernels/res2_block_kernel.py
// (tests/test_torch_native_runtime.py compares the two).
constexpr const char* kSchema =
    "res2_block(Tensor x, Tensor w1, Tensor b1, Tensor wc1, Tensor bc1, "
    "Tensor wc2, Tensor bc2, Tensor w3, Tensor b3, Tensor? wsc, "
    "Tensor p_w1, Tensor p_wc1, Tensor p_wc2, Tensor p_w3, "
    "Tensor? p_wsc, int stride) -> Tensor";

std::atomic<int64_t> g_launches_f32{0};
std::atomic<int64_t> g_launches_bf16{0};
std::unique_ptr<torch::Library> g_def, g_cpu, g_cuda;

using OptTensor = std::optional<at::Tensor>;

at::Tensor Relu20(const at::Tensor& t) { return at::clamp(t, 0.0, 20.0); }

// F.conv2d on float32 operands (a bf16 block's products in float32)
at::Tensor Conv(const at::Tensor& a, const at::Tensor& k, const OptTensor& b,
                int64_t stride, int64_t pad) {
  return at::conv2d(a.to(at::kFloat), k.to(at::kFloat), b, {stride, stride},
                    {pad, pad});
}

void CheckDtype(const at::Tensor& x, const at::Tensor& w1) {
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
              "res2 block: x must be float32 or bfloat16, got ",
              x.scalar_type());
  TORCH_CHECK(x.scalar_type() == w1.scalar_type(), "res2 block: x is ",
              x.scalar_type(), ", the fold ", w1.scalar_type());
}

// res2_block_plain: the block with ATen convolutions on the folded weights;
// in bf16 rounded to bf16 at h, y1, y2 and the output, u = s2 + y1 a bf16
// sum, the identity shortcut x up-cast.
at::Tensor Res2Cpu(const at::Tensor& x, const at::Tensor& w1,
                   const at::Tensor& b1, const at::Tensor& wc1,
                   const at::Tensor& bc1, const at::Tensor& wc2,
                   const at::Tensor& bc2, const at::Tensor& w3,
                   const at::Tensor& b3, const OptTensor& wsc,
                   const at::Tensor&, const at::Tensor&, const at::Tensor&,
                   const at::Tensor&, const OptTensor&, int64_t stride) {
  CheckDtype(x, w1);
  const auto dt = x.scalar_type();
  const int64_t w = bc1.size(0);
  auto h = Relu20(Conv(x, w1, b1, stride, 0)).to(dt);
  auto y1 = Relu20(Conv(h.narrow(1, 0, w), wc1, bc1, 1, 1)).to(dt);
  auto y2 = Relu20(Conv(h.narrow(1, w, w) + y1, wc2, bc2, 1, 1)).to(dt);
  auto out = Conv(at::cat({y1, y2}, 1), w3, b3, 1, 0);
  auto res = wsc.has_value() ? Conv(x, *wsc, std::nullopt, stride, 0)
                             : x.to(at::kFloat);
  return Relu20(out + res).to(dt);
}

#ifdef S3D_WITH_CUDA
// res2_block_cuda: the same checks, then one launch of the kernel.
at::Tensor Res2Cuda(const at::Tensor& x_in, const at::Tensor& w1,
                    const at::Tensor& b1, const at::Tensor&,
                    const at::Tensor& bc1, const at::Tensor&,
                    const at::Tensor& bc2, const at::Tensor& w3,
                    const at::Tensor& b3, const OptTensor& wsc,
                    const at::Tensor& p_w1, const at::Tensor& p_wc1,
                    const at::Tensor& p_wc2, const at::Tensor& p_w3,
                    const OptTensor& p_wsc, int64_t stride) {
  TORCH_CHECK(x_in.is_cuda() && x_in.dim() == 4,
              "res2 kernel: x must be a [B, C, F, T] CUDA tensor");
  CheckDtype(x_in, w1);
  TORCH_CHECK(stride == 1 || stride == 2, "res2 kernel: unsupported stride ",
              stride);
  const at::Tensor x = x_in.contiguous();
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  const int64_t batch = x.size(0), cin = x.size(1), fin = x.size(2),
                tin = x.size(3);
  const int64_t w = bc1.size(0), cout = w3.size(0);
  TORCH_CHECK(w1.size(1) == cin, "res2 kernel: x has ", cin,
              " channels, the block expects ", w1.size(1));
  TORCH_CHECK(wsc.has_value() || (stride == 1 && cin == cout),
              "res2 kernel: identity shortcut needs stride 1 and Cin == Cout");
  TORCH_CHECK(wsc.has_value() == p_wsc.has_value(),
              "res2 kernel: wsc and p_wsc must both be given or both None");
  const int64_t ks = bf16 ? 16 : 8;  // K per mma k-step
  auto packed_ok = [&](const at::Tensor& t, int64_t k, int64_t n) {
    return t.dim() == 4 && t.size(0) == (k + ks - 1) / ks &&
           t.size(1) == (n + 7) / 8 && t.size(2) == 32 && t.size(3) == 4;
  };
  TORCH_CHECK(packed_ok(p_w1, cin, 2 * w) && packed_ok(p_wc1, 9 * w, w) &&
                  packed_ok(p_wc2, 9 * w, w) && packed_ok(p_w3, 2 * w, cout) &&
                  (!p_wsc.has_value() || packed_ok(*p_wsc, cin, cout)),
              "res2 kernel: the weights are not packed for this block");
  std::vector<at::Tensor> packed = {p_w1, p_wc1, p_wc2, p_w3};
  if (p_wsc.has_value()) packed.push_back(*p_wsc);
  for (const auto& t : packed)
    TORCH_CHECK(t.device() == x.device() &&
                    t.scalar_type() == x.scalar_type() && t.is_contiguous(),
                "res2 kernel: folded weights must be contiguous ",
                x.scalar_type(), " on x's device");
  for (const auto& t : {b1, bc1, bc2, b3})
    TORCH_CHECK(t.device() == x.device() && t.scalar_type() == at::kFloat &&
                    t.is_contiguous(),
                "res2 kernel: biases must be contiguous float32 on x's device");
  auto out = at::empty({batch, cout, (fin + stride - 1) / stride,
                        (tin + stride - 1) / stride},
                       x.options());
  if (out.numel() == 0) return out;
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  auto entry = bf16 ? s3d_res2_block_bf16 : s3d_res2_block_f32;
  const int rc = entry(
      x.data_ptr(), p_w1.data_ptr(), b1.data_ptr(), p_wc1.data_ptr(),
      bc1.data_ptr(), p_wc2.data_ptr(), bc2.data_ptr(), p_w3.data_ptr(),
      b3.data_ptr(), p_wsc.has_value() ? p_wsc->data_ptr() : nullptr,
      out.data_ptr(), static_cast<int>(batch), static_cast<int>(cin),
      static_cast<int>(w), static_cast<int>(cout), static_cast<int>(fin),
      static_cast<int>(tin), static_cast<int>(stride), stream);
  TORCH_CHECK(rc == 0, bf16 ? "s3d_res2_block_bf16" : "s3d_res2_block_f32",
              ": CUDA error ", rc, " (", s3d_errstr(rc), ")");
  ++(bf16 ? g_launches_bf16 : g_launches_f32);
  return out;
}
#endif

}  // namespace

void RegisterRes2Op() {
  static std::once_flag once;
  std::call_once(once, [] {
    g_def = std::make_unique<torch::Library>(
        torch::Library::DEF, "s3d", std::nullopt, __FILE__, __LINE__);
    g_def->def(kSchema);
    g_cpu = std::make_unique<torch::Library>(
        torch::Library::IMPL, "s3d", c10::DispatchKey::CPU, __FILE__,
        __LINE__);
    g_cpu->impl("res2_block", TORCH_FN(Res2Cpu));
#ifdef S3D_WITH_CUDA
    g_cuda = std::make_unique<torch::Library>(
        torch::Library::IMPL, "s3d", c10::DispatchKey::CUDA, __FILE__,
        __LINE__);
    g_cuda->impl("res2_block", TORCH_FN(Res2Cuda));
#endif
  });
}

std::string Res2Schema() {
  RegisterRes2Op();
  std::ostringstream ss;
  ss << c10::Dispatcher::singleton()
            .findSchemaOrThrow("s3d::res2_block", "")
            .schema();
  return ss.str();
}

int64_t Res2Launches(bool bf16) {
  return bf16 ? g_launches_bf16.load() : g_launches_f32.load();
}

}  // namespace s3d
