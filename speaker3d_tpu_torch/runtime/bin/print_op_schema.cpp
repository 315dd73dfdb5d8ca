// Registers s3d::res2_block as the native runtime does and prints its
// schema, so the C++ and Python registrations can be held equal
// (tests/test_torch_native_runtime.py).
//
// Usage: print_op_schema

#include <cstdio>

#include "s3d/res2_op.h"

int main() {
  std::printf("%s\n", s3d::Res2Schema().c_str());
  return 0;
}
