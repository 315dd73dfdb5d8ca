"""Batched embedding extraction: wav batch -> fbank -> backbone.

The counterpart of ``speaker3d_tpu/eval/embedding.py``. The returned
callable is the device hot path of diarization: PCM16 decode, the fbank
kernel, mean-norm over time, the backbone, float32 out. ``build_feature_fn``
is the fbank alone. ``dtype=torch.bfloat16`` runs the backbone in bf16 (the
Res2 blocks through the Res2 kernel's bf16 variant); the fbank stays fp32.
``build_sharded_embedding_fn`` is the data-parallel form over a mesh's
``data`` axis: each rank embeds its rows of the batch and every rank gets
the whole batch's embeddings.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Mapping, Optional

import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.parallel.mesh import Mesh, all_gather, data_sharded, shard

# The JAX package's precision names. "high" (what the diarization CLI passes)
# and "float32" keep full fp32 products; None lets cuDNN and cuBLAS use TF32.
_TF32 = {"high": False, "float32": False, "highest": False, None: True}


@contextlib.contextmanager
def matmul_precision(precision: Optional[str], device=None):
    """Set TF32 for cuDNN convolutions and cuBLAS matmuls for the block and
    restore both flags afterwards. The flags are the process's: ``device``,
    when it is the CPU, leaves them alone (they govern CUDA only), so a CPU
    computation in one thread never changes a card computation's precision
    in another."""
    if precision not in _TF32:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{sorted(k for k in _TF32 if k)} or None")
    if device is not None and torch.device(device).type == "cpu":
        yield
        return
    cudnn, cuda = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cuda.allow_tf32)
    cudnn.allow_tf32 = cuda.allow_tf32 = _TF32[precision]
    try:
        yield
    finally:
        cudnn.allow_tf32, cuda.allow_tf32 = saved


def build_embedding_fn(model: torch.nn.Module,
                       state: Optional[Mapping[str, torch.Tensor]] = None, *,
                       device=DEFAULT_DEVICE, precision: Optional[str] = "float32",
                       mean_norm: bool = True, sample_rate: int = 16000,
                       num_mel_bins: int = 80,
                       dtype: Optional[torch.dtype] = None) -> Callable:
    """Return ``embed(wavs) -> [B, D] float32 tensor on ``device````.

    ``state``: a state_dict loaded into ``model`` with ``strict=True`` (None
    keeps the model's weights). ``wavs``: [B, L] float32, or int16 PCM
    decoded as k/32768; a tensor or array, moved to ``device`` if needed.
    ``precision``: "high"/"float32"/"highest" run fp32 (TF32 off), None
    allows TF32. ``dtype``: the backbone's compute dtype (e.g.
    ``torch.bfloat16``); the fbank runs in float32 and its features are
    cast to it. A torch module takes no bf16 input beside fp32 weights, so
    ``dtype`` also casts the model's floating parameters and buffers in
    place, as the JAX package's callers cast the variables before they
    pass a bf16 ``dtype`` (``bench.py``, ``tools/bench_diarization.py``)."""
    dev = resolve_device(device)
    if state is not None:
        model.load_state_dict(state, strict=True)
    model.to(dev).eval()
    if dtype is not None:
        model.to(dtype)
    fbank = KaldiFbank(FbankConfig(sample_rate=sample_rate,
                                   num_mel_bins=num_mel_bins),
                       mean_norm=mean_norm, device=dev)
    if precision not in _TF32:
        raise ValueError(f"unknown precision {precision!r}")

    def embed(wavs):
        with torch.inference_mode(), matmul_precision(precision, dev):
            wavs = torch.as_tensor(wavs, device=dev)
            if wavs.dtype == torch.int16:
                # k/32768 is a power-of-two scale: bitwise equal to the host
                # float conversion of the same PCM16 samples
                wavs = wavs.to(torch.float32) * (1.0 / 32768)
            feats = fbank(wavs.to(torch.float32))
            if dtype is not None:
                feats = feats.to(dtype)
            return model(feats).to(torch.float32)

    return embed


def build_sharded_embedding_fn(model: torch.nn.Module,
                               state: Optional[Mapping[str, torch.Tensor]],
                               mesh: Mesh, *, sample_rate: int = 16000,
                               num_mel_bins: int = 80, mean_norm: bool = True,
                               dtype: Optional[torch.dtype] = None,
                               precision: Optional[str] = "float32"
                               ) -> Callable:
    """Data-parallel ``build_embedding_fn`` over ``mesh``'s ``data`` axis:
    the parameters replicated (``model`` and ``state`` as every rank holds
    them), the batch [B, L] split into contiguous row blocks over ``data``,
    the fbank and the backbone (on a card K1 and K2) on each rank's block
    on the mesh's device, and the [B, D] float32 embeddings gathered to
    every rank, as the JAX function's replicated output. B must divide by
    the data axis; every rank of the mesh calls with the same batch."""
    n_data = mesh.shape["data"]
    embed = build_embedding_fn(model, state, device=mesh.device,
                               precision=precision, mean_norm=mean_norm,
                               sample_rate=sample_rate,
                               num_mel_bins=num_mel_bins, dtype=dtype)

    def run(wavs):
        if wavs.shape[0] % n_data:
            raise AssertionError(f"batch {wavs.shape[0]} not divisible by "
                                 f"data axis {n_data}")
        rows = embed(shard(wavs, data_sharded(mesh, 2)))
        with torch.inference_mode():
            return all_gather(rows, mesh, "data")

    return run


def build_feature_fn(*, sample_rate: int = 16000, num_mel_bins: int = 80,
                     mean_norm: bool = True,
                     device=DEFAULT_DEVICE) -> Callable:
    """Return ``features(wav) -> log-mel [..., T, num_mel_bins]`` on
    ``device`` (the fbank kernel on a card): ``wav`` [n] or [B, n] float32,
    a tensor or array, moved to ``device`` if needed."""
    dev = resolve_device(device)
    fbank = KaldiFbank(FbankConfig(sample_rate=sample_rate,
                                   num_mel_bins=num_mel_bins),
                       mean_norm=mean_norm, device=dev)

    def features(wav):
        with torch.inference_mode():
            return fbank(torch.as_tensor(wav, device=dev).to(torch.float32))

    return features
