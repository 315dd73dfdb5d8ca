"""The chunk plan of batch speaker-verification extraction.

The counterpart of ``speaker3d_tpu/eval/chunking.py``: each utterance is cut
at 90 s into 10 s chunks, the last partial chunk circle-padded, and the
chunk embeddings averaged. With duration buckets, the last partial chunk pads
to the SMALLEST bucket that holds it instead of the full chunk, so a short
utterance embeds fewer padded samples.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from speaker3d_tpu_torch.diar.pipeline import circle_pad


class ChunkSpec(NamedTuple):
    start: int   # sample offset into the wav
    length: int  # real samples in this chunk
    padded: int  # bucket size to circle-pad to


def plan_chunks(n_samples: int, bucket_samples: Sequence[int],
                max_samples: int) -> List[ChunkSpec]:
    """``bucket_samples``: ascending; the LAST one is the chunk size."""
    plan: List[ChunkSpec] = []
    if n_samples <= 0 or not bucket_samples:
        return plan
    chunk = bucket_samples[-1]
    n = min(n_samples, max_samples)
    for s in range(0, n, chunk):
        length = min(chunk, n - s)
        padded = next((b for b in bucket_samples if b >= length), chunk)
        plan.append(ChunkSpec(s, length, padded))
    return plan


def embed_mean_over_plan(embed_fn, wav, plan: Sequence[ChunkSpec]):
    """Embed each planned chunk (circle-padded) alone and average: the
    one-chunk-at-a-time path that batched extraction must match."""
    embs = []
    for c in plan:
        piece = circle_pad(wav[c.start:c.start + c.length], c.padded)
        embs.append(torch.as_tensor(embed_fn(piece[None]))[0].cpu().numpy())
    return np.mean(np.stack(embs), axis=0)
