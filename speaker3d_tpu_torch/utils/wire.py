"""Host->device wire format.

``wire_quantize``: audio as int16 iff EVERY sample is exactly k/32768, so
that the device-side ``x.float() * (1/32768)`` is bitwise identical to the
host float path (k/32768 is a power-of-two scale). Value-based, so it is safe
for any source: PCM16-decoded audio passes, resampled float audio fails and
ships float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def wire_quantize(wav: np.ndarray) -> Optional[np.ndarray]:
    """int16 view of ``wav`` (any shape) iff exactly representable, else
    None. Blockwise, so temporaries stay bounded and the first block
    short-circuits the common non-PCM case."""
    if wav.size == 0:
        return None
    flat = np.ascontiguousarray(wav, dtype=np.float32).reshape(-1)
    out = np.empty(flat.shape[0], np.int16)
    block = 1 << 22
    for s in range(0, flat.shape[0], block):
        x = flat[s:s + block] * np.float32(32768.0)
        r = np.rint(x)
        if not (np.array_equal(r, x) and r.min() >= -32768.0
                and r.max() <= 32767.0):
            return None
        out[s:s + block] = r.astype(np.int16)
    return out.reshape(wav.shape)
