// Variable-length serving plan: split a waveform into fixed chunks and
// circle-pad each to a duration bucket, mirroring the Python batch
// semantics exactly (speaker3d_tpu_torch/eval/chunking.py::plan_chunks;
// behavioral contract from the reference's infer_sv_batch chunking,
// reference: speakerlab/bin/infer_sv_batch.py:388-411: 10 s chunks, 90 s
// cap, final partial chunk circle-padded, chunk-embedding mean).
//
// With duration buckets (speaker3d_tpu_torch/cli/export_speaker_embedding.py --aot_buckets)
// the final partial chunk pads to the SMALLEST bucket that holds it
// instead of always the full chunk — the AOT analogue of the reference's
// dynamic ONNX frame axis, for AOTInductor packages of static shape.
#pragma once

#include <cstdint>
#include <vector>

namespace s3d {

struct ChunkSpec {
  int64_t start;   // sample offset into the wav
  int64_t length;  // real samples in this chunk
  int64_t padded;  // bucket size to circle-pad to
};

// buckets: ascending bucket lengths in samples; the LAST one is the chunk
// size. max_samples caps total audio (the 90 s rule).
inline std::vector<ChunkSpec> PlanChunks(int64_t n_samples,
                                         const std::vector<int64_t>& buckets,
                                         int64_t max_samples) {
  std::vector<ChunkSpec> plan;
  if (n_samples <= 0 || buckets.empty()) return plan;
  const int64_t chunk = buckets.back();
  const int64_t n = n_samples < max_samples ? n_samples : max_samples;
  for (int64_t s = 0; s < n; s += chunk) {
    const int64_t len = (n - s) < chunk ? (n - s) : chunk;
    int64_t padded = chunk;
    for (int64_t b : buckets) {
      if (b >= len) {
        padded = b;
        break;
      }
    }
    plan.push_back({s, len, padded});
  }
  return plan;
}

// Tile-pad to target length (reference: utils/utils.py:232-238 circle_pad).
inline std::vector<float> CirclePad(const float* x, int64_t n,
                                    int64_t target) {
  std::vector<float> out(static_cast<size_t>(target), 0.0f);
  if (n <= 0) return out;
  for (int64_t i = 0; i < target; ++i) out[i] = x[i % n];
  return out;
}

}  // namespace s3d
