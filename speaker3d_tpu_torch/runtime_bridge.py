"""Python side of the port's native serving runtime.

The counterpart of ``speaker3d_tpu/runtime_bridge.py``. The C++ CLI
(``runtime/bin/extract_speaker_embedding.cpp`` of this package, ``--engine
bridge``) embeds CPython and calls these two functions; WAV decode, fbank
and timing are native C++. The model is the port's eager module, loaded
once at ``init``, on the card unless ``device="cpu"`` (the Res2 blocks of the
ERes2Net models through the Res2 kernel there).
"""

from __future__ import annotations

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device

_STATE = {}


def init(model_spec: str, local_model_dir: str = "pretrained",
         feat_dim: int = 80, precision: str = "high",
         device: str = DEFAULT_DEVICE) -> int:
    """model_spec: a registry model id OR an exp_dir path. Returns 0 on ok;
    raises without a CUDA device unless ``device`` is "cpu"."""
    from speaker3d_tpu_torch.cli.extract import load_model
    from speaker3d_tpu_torch.cli.registry import SUPPORTS
    from speaker3d_tpu_torch.eval.embedding import matmul_precision

    dev = resolve_device(device)
    if model_spec in SUPPORTS:
        model = load_model(None, model_spec, local_model_dir)
    else:
        model = load_model(model_spec, None, local_model_dir)
    model = model.to(dev).eval()

    def run(feats: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), matmul_precision(precision, dev):
            return model(feats.to(dev))

    _STATE.update(run=run, feat_dim=feat_dim)
    return 0


def embed(feats_bytes: bytes, num_frames: int, feat_dim: int) -> bytes:
    """float32 features [num_frames, feat_dim] (one utterance) -> float32
    embedding bytes."""
    feats = np.frombuffer(feats_bytes, dtype=np.float32).reshape(
        1, num_frames, feat_dim)
    out = _STATE["run"](torch.from_numpy(feats.copy()))[0]
    return out.to(torch.float32).cpu().numpy().tobytes()
