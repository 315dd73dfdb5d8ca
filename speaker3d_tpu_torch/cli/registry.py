"""Pretrained model registry: model_id -> architecture + checkpoint file.

The counterpart of ``speaker3d_tpu/cli/registry.py`` for the two ERes2NetV2
ids this package ports. Checkpoints are the reference's torch files and load
straight into the module with ``strict=True``; they must already exist
under ``local_model_dir/<model_id>/<model_pt>`` (modelscope's snapshot
layout), since nothing here downloads.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from speaker3d_tpu_torch.compat.flax_convert import load_torch_checkpoint
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2

ERes2NetV2_COMMON = {"obj": ERes2NetV2,
                     "args": {"feat_dim": 80, "embedding_size": 192,
                              "base_width": 26, "scale": 2, "expansion": 2}}
ERes2NetV2_w24s4ep4_COMMON = {
    "obj": ERes2NetV2,
    "args": {"feat_dim": 80, "embedding_size": 192,
             "base_width": 24, "scale": 4, "expansion": 4}}

SUPPORTS: Dict[str, Dict[str, Any]] = {
    "iic/speech_eres2netv2_sv_zh-cn_16k-common": {
        "revision": "v1.0.1", "model": ERes2NetV2_COMMON,
        "model_pt": "pretrained_eres2netv2.ckpt"},
    "iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common": {
        "revision": "v1.0.1", "model": ERes2NetV2_w24s4ep4_COMMON,
        "model_pt": "pretrained_eres2netv2w24s4ep4.ckpt"},
}

# ids of the JAX registry whose backbones are not ported yet
NOT_PORTED = (
    "iic/speech_campplus_sv_zh-cn_16k-common",
    "iic/speech_eres2net_sv_zh-cn_16k-common",
    "iic/speech_eres2net_base_200k_sv_zh-cn_16k-common",
    "iic/speech_campplus_sv_zh_en_16k-common_advanced",
    "iic/speech_campplus_sv_en_voxceleb_16k",
    "iic/speech_eres2net_sv_en_voxceleb_16k",
    "iic/speech_eres2net_base_sv_zh-cn_3dspeaker_16k",
    "iic/speech_eres2net_large_sv_zh-cn_3dspeaker_16k",
    "iic/speech_ecapa-tdnn_sv_zh-cn_cnceleb_16k",
    "iic/speech_ecapa-tdnn_sv_zh-cn_3dspeaker_16k",
    "iic/speech_ecapa-tdnn_sv_en_voxceleb_16k",
)


def build_model(model_id: str) -> ERes2NetV2:
    """Instantiate the (randomly initialised) module for a registry id."""
    if model_id in NOT_PORTED:
        raise NotImplementedError(
            f"model id {model_id!r}: its backbone is not ported to the "
            f"PyTorch package yet (ROADMAP.md, M10)")
    if model_id not in SUPPORTS:
        raise KeyError(f"model id {model_id!r} not supported; "
                       f"known: {sorted(SUPPORTS)}")
    spec = SUPPORTS[model_id]["model"]
    return spec["obj"](**spec["args"])


def load_pretrained(model_id: str, local_model_dir: str = "pretrained"):
    """Build the module and load its torch checkpoint (``strict=True``)."""
    model = build_model(model_id)
    ckpt_path = os.path.join(local_model_dir, model_id,
                             SUPPORTS[model_id]["model_pt"])
    if not os.path.isfile(ckpt_path):
        raise FileNotFoundError(
            f"checkpoint not found at {ckpt_path}; this environment has no "
            f"network egress — place the modelscope snapshot there")
    model.load_state_dict(load_torch_checkpoint(ckpt_path), strict=True)
    return model.eval()
