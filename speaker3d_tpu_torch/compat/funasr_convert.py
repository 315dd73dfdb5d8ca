"""funasr Paraformer checkpoint -> the port's SAN-M encoder.

The counterpart of ``speaker3d_tpu/compat/funasr_convert.py``. A funasr
``model.pt`` keeps the encoder under ``encoder.`` (``encoder.encoders0.0...``,
``encoder.encoders.N...``, ``encoder.after_norm...``), in torch layout under
the same module names as ``models/sanm.py::SANMEncoder`` (the depthwise
``fsmn_block`` a grouped ``Conv1d`` [d_model, 1, k], the FFN's ``w_1`` and
``w_2`` Linears), so a load is a prefix strip and ``load_state_dict`` with
``strict=True``; no layout conversion.

funasr's LayerNorms use torch's eps 1e-5, the SAN-M encoder Flax's 1e-6
(``models/sanm.py::LAYER_NORM_EPS``), as in the JAX package: the outputs
differ by that alone.
"""

from __future__ import annotations

from typing import Any, Mapping, Union

import torch

from speaker3d_tpu_torch.compat.flax_convert import load_torch_checkpoint


def extract_encoder_state(state_dict: Mapping[str, Any],
                          prefix: str = "encoder.") -> dict:
    """Keep only `<prefix>*` keys, stripped of the prefix. If no key carries
    the prefix, the dict is assumed to already be encoder-only."""
    sub = {k[len(prefix):]: v for k, v in state_dict.items()
           if k.startswith(prefix)}
    return sub if sub else dict(state_dict)


def load_funasr_encoder(ckpt: Union[str, Mapping[str, Any]],
                        encoder: torch.nn.Module) -> torch.nn.Module:
    """A funasr ``model.pt`` path (or its state_dict, or an encoder-only
    one) loaded into ``encoder`` (a ``SANMEncoder``) in place, which is
    returned.

    ``encoder`` must be configured as the checkpoint (input_dim, d_model,
    heads, ffn_dim, num_layers, kernel_size): a shape mismatch raises
    ``ValueError`` naming the key, a missing or extra key ``RuntimeError``
    (``strict=True``)."""
    sd = load_torch_checkpoint(ckpt) if isinstance(ckpt, str) else dict(ckpt)
    sd = {k: torch.as_tensor(v) for k, v in extract_encoder_state(sd).items()}
    like = encoder.state_dict()
    for k, v in sd.items():
        if k in like and tuple(v.shape) != tuple(like[k].shape):
            raise ValueError(f"funasr encoder key '{k}': checkpoint shape "
                             f"{tuple(v.shape)} differs from the encoder's "
                             f"{tuple(like[k].shape)}")
    encoder.load_state_dict(sd, strict=True)
    return encoder
