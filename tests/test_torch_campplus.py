"""The PyTorch port's CAM++ (models/campplus.py) against the JAX package's,
and the diarization CLIs of both packages on a CAM++ registry id.

Weights come from a JAX init with randomised BatchNorm statistics
(``tests/test_torch_eres2netv2.py::jax_variables``), cross over through
``state_dict_from_flax`` with the port module's state_dict as ``like`` (the
JAX ``nn.Dense`` of ``xvector.dense.linear`` is a k=1 ``Conv1d`` in the
port) and load with ``strict=True``. Embeddings are compared after dividing
both by the reference's largest magnitude, at rtol = atol = 3e-4 (fp32 sums
in another order over the trunk).
"""

import os

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.cli import infer_diarization as jcli
from speaker3d_tpu.cli import registry as jreg
from speaker3d_tpu.models.campplus import CAMPPlus as JaxCAMPPlus
from speaker3d_tpu.models.campplus import seg_avg_pool_expand as jax_seg_pool
from speaker3d_tpu_torch.cli import infer_diarization as tcli
from speaker3d_tpu_torch.cli import registry as treg
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models.campplus import CAMPPlus, seg_avg_pool_expand
from speaker3d_tpu_torch.utils.fileio import write_wav
from tests.test_diar_pipeline import _two_speaker_wav
from tests.test_torch_eres2netv2 import assert_close_scaled, jax_variables
from tests.torch_threads import cap_torch_threads  # noqa: F401

# narrow dense layers; the FCM head keeps its 32 channels
SMALL = dict(feat_dim=80, embedding_size=32, growth_rate=8, bn_size=2,
             init_channels=16)
MODEL_ID = "iic/speech_campplus_sv_zh-cn_16k-common"
# These random weights embed the two tones' chunks at cosine >= 0.99977
# within a tone and <= 0.99906 across: a cut between splits them
COS_THR = 0.9994


@pytest.fixture(scope="module")
def weights():
    jm = JaxCAMPPlus(**SMALL)
    return jm, jax_variables(jm, t=60, seed=5)


def port_campplus(variables, **kw):
    model = CAMPPlus(**kw)
    model.load_state_dict(state_dict_from_flax(variables,
                                               like=model.state_dict()),
                          strict=True)
    return model.eval()


def test_matches_jax_with_a_partial_cam_segment(weights):
    """298 frames: 149 after the stride-2 TDNN stem, so every CAM layer's
    last 100-frame segment holds 49 frames."""
    jm, variables = weights
    feats = np.random.default_rng(6).standard_normal((2, 298, 80)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, feats))
    with torch.inference_mode():
        out = port_campplus(variables, **SMALL)(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape == (2, 32)
    assert_close_scaled(out, ref, 3e-4)


@pytest.mark.parametrize("t", [37, 100, 149, 250])
def test_segment_pooling_matches_jax(t):
    x = np.random.default_rng(t).standard_normal((2, t, 5)).astype(np.float32)
    want = np.asarray(jax_seg_pool(x))                      # [B, T, C]
    got = seg_avg_pool_expand(torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_dense_kernel_reshaped_to_conv1d_and_misfits_refused(weights):
    _, variables = weights
    like = CAMPPlus(**SMALL).state_dict()
    sd = state_dict_from_flax(variables, like=like)
    assert sd["xvector.dense.linear.weight"].shape == (32, like[
        "xvector.dense.linear.weight"].shape[1], 1)
    assert set(sd) == set(like)
    with pytest.raises(ValueError, match="xvector.dense.linear.weight"):
        state_dict_from_flax(variables, like={
            **like, "xvector.dense.linear.weight": torch.zeros(32, 7, 1)})


def test_diarization_cli_rttm_bytes_equal_jax(weights, tmp_path, monkeypatch):
    """Both packages' diarization CLIs on a CAM++ id whose registry
    arguments are narrowed, the same weights in both."""
    _, variables = weights
    for key, val in SMALL.items():
        monkeypatch.setitem(jreg.SUPPORTS[MODEL_ID]["model"]["args"], key, val)
        monkeypatch.setitem(treg.SUPPORTS[MODEL_ID]["model"]["args"], key, val)
    ckpt = tmp_path / "pretrained" / MODEL_ID / treg.SUPPORTS[MODEL_ID]["model_pt"]
    os.makedirs(ckpt.parent)
    torch.save(port_campplus(variables, **SMALL).state_dict(), ckpt)
    wav, _, fs = _two_speaker_wav()
    wav_path = str(tmp_path / "conv.wav")
    write_wav(wav_path, wav, fs)
    common = ["--wav", wav_path, "--model_id", MODEL_ID, "--local_model_dir",
              str(tmp_path / "pretrained"), "--cluster_mer_cos", str(COS_THR),
              "--cluster_fix_cos_thr", str(COS_THR)]
    jcli.main(common + ["--out_dir", str(tmp_path / "jax")])
    tcli.main(common + ["--out_dir", str(tmp_path / "torch"), "--device",
                        "cpu"])
    with open(tmp_path / "jax" / "conv.rttm", "rb") as f:
        want = f.read()
    with open(tmp_path / "torch" / "conv.rttm", "rb") as f:
        got = f.read()
    assert got == want
    assert len({line.split()[7] for line in got.splitlines()}) == 2
