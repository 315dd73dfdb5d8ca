"""Pretrained model registry: model_id -> architecture + checkpoint file.

The counterpart of ``speaker3d_tpu/cli/registry.py``: the same 13 ids with
the same arguments. Checkpoints are the reference's torch files and load
straight into the module with ``strict=True``; they must already exist
under ``local_model_dir/<model_id>/<model_pt>`` (modelscope's snapshot
layout), since nothing here downloads.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from torch import nn

from speaker3d_tpu_torch.compat.flax_convert import load_torch_checkpoint
from speaker3d_tpu_torch.models.campplus import CAMPPlus
from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
from speaker3d_tpu_torch.models.eres2net import ERes2Net
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2

CAMPPLUS_VOX = {"obj": CAMPPlus,
                "args": {"feat_dim": 80, "embedding_size": 512}}
CAMPPLUS_COMMON = {"obj": CAMPPlus,
                   "args": {"feat_dim": 80, "embedding_size": 192}}
ERes2Net_VOX = {"obj": ERes2Net,
                "args": {"feat_dim": 80, "embedding_size": 192}}
ERes2NetV2_COMMON = {"obj": ERes2NetV2,
                     "args": {"feat_dim": 80, "embedding_size": 192,
                              "base_width": 26, "scale": 2, "expansion": 2}}
ERes2NetV2_w24s4ep4_COMMON = {
    "obj": ERes2NetV2,
    "args": {"feat_dim": 80, "embedding_size": 192,
             "base_width": 24, "scale": 4, "expansion": 4}}
ERes2Net_COMMON = {  # the "huge" block variant (reference: ERes2Net_huge.py)
    "obj": ERes2Net,
    "args": {"feat_dim": 80, "embedding_size": 192, "m_channels": 64,
             "base_width": 24, "scale": 3, "expansion": 4}}
ERes2Net_base_COMMON = {"obj": ERes2Net,
                        "args": {"feat_dim": 80, "embedding_size": 512,
                                 "m_channels": 32}}
ERes2Net_Base_3D_Speaker = ERes2Net_base_COMMON
ERes2Net_Large_3D_Speaker = {"obj": ERes2Net,
                             "args": {"feat_dim": 80, "embedding_size": 512,
                                      "m_channels": 64}}
ECAPA_CNCeleb = {"obj": ECAPA_TDNN,
                 "args": {"input_size": 80, "lin_neurons": 192,
                          "channels": (1024, 1024, 1024, 1024, 3072)}}

SUPPORTS: Dict[str, Dict[str, Any]] = {
    "iic/speech_campplus_sv_zh-cn_16k-common": {
        "revision": "v1.0.0", "model": CAMPPLUS_COMMON,
        "model_pt": "campplus_cn_common.bin"},
    "iic/speech_eres2net_sv_zh-cn_16k-common": {
        "revision": "v1.0.5", "model": ERes2Net_COMMON,
        "model_pt": "pretrained_eres2net_aug.ckpt"},
    "iic/speech_eres2netv2_sv_zh-cn_16k-common": {
        "revision": "v1.0.1", "model": ERes2NetV2_COMMON,
        "model_pt": "pretrained_eres2netv2.ckpt"},
    "iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common": {
        "revision": "v1.0.1", "model": ERes2NetV2_w24s4ep4_COMMON,
        "model_pt": "pretrained_eres2netv2w24s4ep4.ckpt"},
    "iic/speech_eres2net_base_200k_sv_zh-cn_16k-common": {
        "revision": "v1.0.0", "model": ERes2Net_base_COMMON,
        "model_pt": "pretrained_eres2net.pt"},
    "iic/speech_campplus_sv_zh_en_16k-common_advanced": {
        "revision": "v1.0.0", "model": CAMPPLUS_COMMON,
        "model_pt": "campplus_cn_en_common.pt"},
    "iic/speech_campplus_sv_en_voxceleb_16k": {
        "revision": "v1.0.2", "model": CAMPPLUS_VOX,
        "model_pt": "campplus_voxceleb.bin"},
    "iic/speech_eres2net_sv_en_voxceleb_16k": {
        "revision": "v1.0.2", "model": ERes2Net_VOX,
        "model_pt": "pretrained_eres2net.ckpt"},
    "iic/speech_eres2net_base_sv_zh-cn_3dspeaker_16k": {
        "revision": "v1.0.1", "model": ERes2Net_Base_3D_Speaker,
        "model_pt": "eres2net_base_model.ckpt"},
    "iic/speech_eres2net_large_sv_zh-cn_3dspeaker_16k": {
        "revision": "v1.0.0", "model": ERes2Net_Large_3D_Speaker,
        "model_pt": "eres2net_large_model.ckpt"},
    "iic/speech_ecapa-tdnn_sv_zh-cn_cnceleb_16k": {
        "revision": "v1.0.0", "model": ECAPA_CNCeleb,
        "model_pt": "ecapa-tdnn.ckpt"},
    "iic/speech_ecapa-tdnn_sv_zh-cn_3dspeaker_16k": {
        "revision": "v1.0.0", "model": ECAPA_CNCeleb,
        "model_pt": "ecapa-tdnn.ckpt"},
    "iic/speech_ecapa-tdnn_sv_en_voxceleb_16k": {
        "revision": "v1.0.1", "model": ECAPA_CNCeleb,
        "model_pt": "ecapa_tdnn.bin"},
}


def build_model(model_id: str) -> nn.Module:
    """Instantiate the (randomly initialised) module for a registry id."""
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
