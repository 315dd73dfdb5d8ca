// s3d::res2_block: the Res2 block kernel (csrc/res2_block.cu) as an
// operator of PyTorch's dispatcher in a process without Python.
//
// The schema is the one speaker3d_tpu_torch/ops/kernels/
// res2_block_kernel.py registers from Python (SCHEMA there): x, the BN-folded
// weights of one scale-2 block (OIHW for the plain version, packed fragments
// for the kernel; the shortcut's Tensor? when it is the identity), the
// stride. An AOTInductor package that carries the operator calls it through
// its proxy executor, so the operator must be registered in the process that
// runs the package: RegisterRes2Op() does it, once.
//
// CPU: ATen convolutions with the plain version's arithmetic (float32, or
// bfloat16 rounded where the TPU kernel rounds). CUDA (built with
// S3D_WITH_CUDA): the kernel library's C entry s3d_res2_block_f32 / _bf16 on
// the current stream; every launch adds one to Res2Launches().
#pragma once

#include <cstdint>
#include <string>

namespace s3d {

void RegisterRes2Op();

// The registered schema as the dispatcher prints it.
std::string Res2Schema();

// Kernel launches in this process: float32 or bfloat16.
int64_t Res2Launches(bool bf16 = false);

}  // namespace s3d
