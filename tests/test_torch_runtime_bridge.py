"""The Python side of the port's native serving runtime
(speaker3d_tpu_torch/runtime_bridge.py), called as the C++ bridge engine
calls it, on the CPU: ``init`` on an experiment dir or a registry id,
``embed`` on fbank bytes, against ``extract --mode exact`` (the same
features and model at batch 1: equal to float32 rounding).
"""

import os

import numpy as np
import pytest
import torch
import yaml

from speaker3d_tpu_torch import runtime_bridge
from speaker3d_tpu_torch.cli import extract as textract
from speaker3d_tpu_torch.cli import registry
from speaker3d_tpu_torch.eval.scoring import load_embeddings
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
from speaker3d_tpu_torch.utils.fileio import load_audio, write_wav
from tests.torch_threads import cap_torch_threads  # noqa: F401

MODEL_ID = "iic/speech_eres2netv2_sv_zh-cn_16k-common"
SMALL = dict(num_blocks=[1, 1, 1, 1], m_channels=8, feat_dim=80,
             embedding_size=16)
FS = 16000


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bridge"))
    torch.manual_seed(0)
    model = ERes2NetV2(**SMALL).eval()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.from_numpy(
                    0.1 * rng.standard_normal(t.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
    exp = os.path.join(root, "exp")
    os.makedirs(exp)
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.safe_dump({"model": {
            "obj": "speaker3d_tpu.models.eres2netv2.ERes2NetV2",
            "args": SMALL}}, f)
    Checkpointer(os.path.join(exp, "models")).save_checkpoint(
        1, {"train_state": {"model": {k: v.numpy() for k, v in
                                      model.state_dict().items()}}})
    ckpt = os.path.join(root, "pretrained", MODEL_ID,
                        registry.SUPPORTS[MODEL_ID]["model_pt"])
    os.makedirs(os.path.dirname(ckpt))
    torch.save(model.state_dict(), ckpt)
    scp = os.path.join(root, "wav.scp")
    with open(scp, "w") as f:
        for utt, sec in (("a", 0.4), ("b", 1.7)):
            n = int(sec * FS)
            wav = (0.2 * np.sin(2 * np.pi * 230 * np.arange(n) / FS)
                   + 0.02 * rng.standard_normal(n)).astype(np.float32)
            write_wav(os.path.join(root, f"{utt}.wav"), wav, FS)
            f.write(f"{utt} {os.path.join(root, utt)}.wav\n")
    ref = os.path.join(root, "ref")
    textract.main(["--exp_dir", exp, "--data", scp, "--out_dir", ref,
                   "--mode", "exact", "--device", "cpu"])
    return {"root": root, "exp": exp, "scp": scp,
            "ref": load_embeddings(ref)}


def _bridge_embeddings(root):
    fbank = KaldiFbank(FbankConfig(), mean_norm=True, device="cpu")
    out = {}
    for utt in ("a", "b"):
        wav = load_audio(os.path.join(root, f"{utt}.wav"), obj_fs=FS)[0]
        feats = fbank(torch.as_tensor(np.asarray(wav))).numpy()
        emb = runtime_bridge.embed(feats.astype(np.float32).tobytes(),
                                   feats.shape[0], feats.shape[1])
        out[utt] = np.frombuffer(emb, dtype=np.float32)
    return out


def test_bridge_on_an_experiment_matches_extract_exact(setup):
    assert runtime_bridge.init(setup["exp"], device="cpu") == 0
    got = _bridge_embeddings(setup["root"])
    for utt, want in setup["ref"].items():
        assert got[utt].shape == (SMALL["embedding_size"],)
        np.testing.assert_allclose(got[utt], want, rtol=1e-5, atol=1e-6)


def test_bridge_on_a_registry_id_matches_extract_exact(setup, monkeypatch):
    monkeypatch.setitem(registry.SUPPORTS[MODEL_ID]["model"], "args",
                        {**registry.SUPPORTS[MODEL_ID]["model"]["args"],
                         "num_blocks": SMALL["num_blocks"],
                         "m_channels": SMALL["m_channels"],
                         "embedding_size": SMALL["embedding_size"]})
    assert runtime_bridge.init(
        MODEL_ID, os.path.join(setup["root"], "pretrained"),
        device="cpu") == 0
    got = _bridge_embeddings(setup["root"])
    for utt, want in setup["ref"].items():
        np.testing.assert_allclose(got[utt], want, rtol=1e-5, atol=1e-6)
