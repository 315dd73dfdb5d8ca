"""The port's export CLI (cli/export_speaker_embedding.py: export_model,
load_exported, frames_for_samples, main) against the JAX package's, on the
CPU.

Both packages load the same small random ERes2NetV2 in the 17.8M model's
geometry (scale 2, expansion 2): the port's layer1-2 blocks reach the Res2
block through the operator ``s3d::res2_block``, which every exported
program carries (its CPU implementation is the plain version). Embeddings
are compared after dividing both by the JAX side's largest magnitude, at
the backbone parity tests' rtol = atol = 3e-4 (tests/test_torch_eres2netv2.py).
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from torch._subclasses.fake_tensor import FakeTensor

from speaker3d_tpu.cli import export_speaker_embedding as jex
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu_torch.cli import export_speaker_embedding as tex
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
from tests.test_torch_eres2netv2 import (
    assert_close_scaled, jax_variables, port_model)
from tests.torch_threads import cap_torch_threads  # noqa: F401

SMALL = dict(num_blocks=(1, 2, 1, 1), m_channels=8, feat_dim=80,
             embedding_size=16, base_width=26, scale=2, expansion=2)
FRAMES = 40
TOL = 3e-4


@pytest.fixture(scope="module")
def weights():
    jm = JaxERes2NetV2(**SMALL)
    return jm, jax_variables(jm, t=FRAMES)


def _feats(batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, FRAMES, 80)).astype(np.float32)


def _res2_nodes(path):
    return [n for n in torch.export.load(path).graph.nodes
            if n.target is torch.ops.s3d.res2_block.default]


@pytest.fixture(scope="module")
def exported(weights, tmp_path_factory):
    """Both CLIs' main on one experiment (each verifies before it writes):
    the JAX .stablehlo and the port's .pt2 with their .json metas."""
    _, variables = weights
    root = str(tmp_path_factory.mktemp("export"))
    exp = _jax_layout_exp(root, variables)
    jout, out = os.path.join(root, "m.stablehlo"), os.path.join(root, "m.pt2")
    jex.main(["--exp_dir", exp, "--out", jout, "--frames", str(FRAMES)])
    tex.main(["--exp_dir", exp, "--out", out, "--frames", str(FRAMES),
              "--device", "cpu"])
    return jout, out


def test_exported_program_matches_jax_at_batch_1_and_5(exported):
    """The dynamic-batch program against the JAX exported function on the
    same weights; its graph calls s3d::res2_block once per layer1-2 block."""
    jpath, path = exported
    assert len(_res2_nodes(path)) == sum(SMALL["num_blocks"][:2])
    jrun, run = jex.load_exported(jpath), tex.load_exported(path)
    for batch, seed in ((1, 3), (5, 4)):
        x = _feats(batch, seed)
        want = np.asarray(jrun(x))
        got = run(x).numpy()
        assert got.shape == want.shape == (batch, SMALL["embedding_size"])
        assert_close_scaled(got, want, TOL)


def test_static_batch_fallback_records_why(weights, monkeypatch):
    """A trace that fails at a dynamic batch falls back to batch 1 and
    records the error, as the JAX export does; the program keeps its
    operator."""
    jm, variables = weights
    real = torch.export.export

    def refuse_dynamic(*a, dynamic_shapes=None, **k):
        if dynamic_shapes is not None:
            raise RuntimeError("no dynamic batch here")
        return real(*a, **k)

    monkeypatch.setattr(torch.export, "export", refuse_dynamic)
    blob, meta = tex.export_model(port_model(variables, **SMALL),
                                  frames=FRAMES, device="cpu")
    assert meta["dynamic_batch"] is False
    assert meta["poly_error"] == "no dynamic batch here"
    program = torch.export.load(__import__("io").BytesIO(blob))
    assert any(n.target is torch.ops.s3d.res2_block.default
               for n in program.graph.nodes)


def test_eager_calls_agree_before_and_after_an_export(weights):
    """The folds are computed before the trace and held as buffers for it:
    after an export the model keeps no fold buffer, its cache holds real
    tensors, and eager calls equal those before the export, also for a
    model exported before its first eager call."""
    _, variables = weights
    x = torch.from_numpy(_feats(3, 5))
    warm, cold = (port_model(variables, **SMALL) for _ in range(2))
    with torch.inference_mode():
        before = warm(x)
    for model in (warm, cold):
        tex.export_model(model, frames=FRAMES, device="cpu")
        blocks = [b for b in model.modules() if getattr(b, "fusable", False)]
        assert blocks and not any(b._frozen for b in blocks)
        assert not any(name.startswith("fold_") or ".fold_" in name
                       for name, _ in model.named_buffers())
        for b in blocks:
            assert not any(isinstance(t, FakeTensor)
                           for fold in b._folds.values()
                           for t in vars(fold).values())
        with torch.inference_mode():
            torch.testing.assert_close(model(x), before, rtol=0, atol=0)


def test_a_trace_never_caches_fake_folds(weights):
    """Without frozen folds a trace folds the fake parameters: the program
    computes the folds itself, and the block's cache stays empty."""
    _, variables = weights
    model = port_model(variables, **SMALL)
    x = torch.from_numpy(_feats(2, 6))
    program = torch.export.export(model, (x,))
    assert all(not b._folds for b in model.modules()
               if getattr(b, "fusable", False))
    with torch.inference_mode():
        torch.testing.assert_close(program.module()(x), model(x))


def test_frames_for_samples_matches_jax():
    for n in [0, 1, 399, 400, 401, 559, 560, 561, 16000, 24000, 48000,
              160000, 1520000] + list(range(380, 900, 7)):
        assert tex.frames_for_samples(n) == jex.frames_for_samples(n), n
        assert (tex.frames_for_samples(n, frame_length=200, frame_shift=80)
                == jex.frames_for_samples(n, frame_length=200,
                                          frame_shift=80))


def _jax_layout_exp(root, variables):
    """An experiment both packages read: config.yaml naming the JAX class,
    the checkpoint's train_state in the JAX trainer's layout."""
    exp = os.path.join(root, "exp")
    os.makedirs(exp)
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.safe_dump({"model": {
            "obj": "speaker3d_tpu.models.eres2netv2.ERes2NetV2",
            "args": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in SMALL.items()}}}, f)
    Checkpointer(os.path.join(exp, "models")).save_checkpoint(
        1, {"train_state": {"params": variables["params"],
                            "batch_stats": variables["batch_stats"]}})
    return exp


def test_main_writes_a_verified_program_like_the_jax_cli(exported, weights):
    """The .json meta has the JAX meta's keys and values plus precision and
    device; export_model returns the same meta; a CLI without a model
    refuses."""
    jout, out = exported
    with open(jout + ".json") as f:
        jmeta = json.load(f)
    with open(out + ".json") as f:
        meta = json.load(f)
    assert meta["dynamic_batch"] and "poly_error" not in meta
    assert set(meta) == set(jmeta) | {"precision", "device"}
    assert {k: meta[k] for k in jmeta} == jmeta
    assert (meta["precision"], meta["device"]) == ("high", "cpu")
    _, direct = tex.export_model(port_model(weights[1], **SMALL),
                                 frames=FRAMES, device="cpu")
    assert direct == meta
    with pytest.raises(SystemExit):
        tex.main(["--out", out, "--device", "cpu"])


def test_export_needs_a_card_unless_asked_for_the_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = ERes2NetV2(**SMALL).eval()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.export_model(model, frames=FRAMES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.main(["--model_id", "x", "--out", "x.pt2"])
