// Prints the variable-length serving plan for given inputs — exists so the
// Python mirror (speaker3d_tpu_torch/eval/chunking.py) can be lockstep-tested
// against the native implementation (tests/test_torch_native_runtime.py).
//
// Usage: print_chunk_plan <n_samples> <max_samples> <bucket1> [bucket2 ...]
// Output: one "start length padded" line per chunk.

#include <cstdio>
#include <cstdlib>
#include <vector>

#include "s3d/chunk_plan.h"

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: %s <n_samples> <max_samples> <bucket...>\n",
                 argv[0]);
    return 1;
  }
  const int64_t n = std::atoll(argv[1]);
  const int64_t max_samples = std::atoll(argv[2]);
  std::vector<int64_t> buckets;
  for (int i = 3; i < argc; ++i) buckets.push_back(std::atoll(argv[i]));
  for (const auto& c : s3d::PlanChunks(n, buckets, max_samples))
    std::printf("%lld %lld %lld\n", static_cast<long long>(c.start),
                static_cast<long long>(c.length),
                static_cast<long long>(c.padded));
  return 0;
}
