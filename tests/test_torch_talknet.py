"""The port's TalkNet (``speaker3d_tpu_torch/models/talknet.py``) against
the JAX package's on the CPU, on seeded random weights with BatchNorm
statistics near 0: the three heads at 1e-4 of their scale at B = 2 and
T = 8 (the visual frontend's 3-D convolution runs over the batch and time
flattened into one depth axis, which shows only at B > 1); the converter
both ways (Flax variables -> state_dict -> Flax variables, bit for bit);
the port's state_dict, whose names are the torch toolkit's, read by the
JAX package's ``load_into_model`` as a cross-check; the ASD scorer and an
``asd_state`` experiment against ``make_talknet_asd_scorer`` at 1e-5."""

import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_threads import cap_torch_threads  # noqa: F401
from speaker3d_tpu.models.talknet import TalkNetModel as JTalkNet
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.diar import video as tvideo
from speaker3d_tpu_torch.models import talknet as ttalknet

B, T = 2, 8


def _inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((b, 4 * t, 13)).astype(np.float32)
    faces = (rng.random((b, t, 112, 112)) * 255).astype(np.float32)
    return audio, faces


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_talknet():
    """The JAX model, its seeded variables with BatchNorm statistics drawn
    near 0 (means 0.1 N(0, 1), variances U(0.5, 1.5)), and the port's
    model holding them."""
    model = JTalkNet()
    audio, faces = _inputs(1, T, 0)
    init = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), audio, faces))
    rng = np.random.default_rng(1)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else (
            (0.1 * rng.standard_normal(v.shape)) if k == "mean"
            else rng.random(v.shape) + 0.5).astype(np.float32)
            for k, v in tree.items()}

    variables = {"params": init["params"],
                 "batch_stats": draw(init["batch_stats"])}
    return model, variables, ttalknet.talknet_from_flax(variables)


def test_three_heads_match_jax(jax_talknet):
    model, variables, port = jax_talknet
    audio, faces = _inputs(B, T, 2)
    want = [np.asarray(x) for x in jax.jit(model.apply)(variables, audio,
                                                         faces)]
    with torch.no_grad():
        got = [x.numpy() for x in port(torch.from_numpy(audio),
                                       torch.from_numpy(faces))]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, T, 2)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    # the depth-axis quirk: clip 1's scores depend on clip 0's last frames
    faces2 = faces.copy()
    faces2[0, -1] = 255.0 - faces2[0, -1]
    with torch.no_grad():
        changed = port(torch.from_numpy(audio), torch.from_numpy(faces2))[2]
    assert float(torch.abs(changed[1, 0] - torch.from_numpy(got[2][1, 0]))
                 .max()) > 0


def test_converter_both_ways(jax_talknet):
    _, variables, port = jax_talknet
    back = ttalknet.flax_variables(port)
    a, b = _flat(back), _flat(variables)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k
    sd = port.state_dict()
    # reference names and torch layouts
    assert tuple(sd["visualFrontend.frontend3D.0.weight"].shape) == (
        64, 1, 5, 7, 7)
    assert tuple(sd["visualTCN.net.0.net.2.weight"].shape) == (512, 1, 3)
    assert tuple(sd["visualTCN.net.0.net.3.weight"].shape) == (1,)
    assert tuple(sd["visualTCN.net.4.net.4.gamma"].shape) == (1, 512, 1)
    assert tuple(sd["crossA2V.self_attn.in_proj_weight"].shape) == (384, 128)
    assert tuple(sd["selfAV.self_attn.out_proj.weight"].shape) == (256, 256)
    assert "audioEncoder.layer2.0.downsample.1.running_var" in sd
    assert "audioEncoder.layer1.0.se.fc.2.bias" in sd


def test_reference_named_state_dict_loads_into_jax(jax_talknet):
    """The JAX package's torch-checkpoint loader reads the port's state_dict
    (the torch toolkit's names) back into the same variables."""
    from speaker3d_tpu.compat import load_into_model

    model, variables, port = jax_talknet
    audio, faces = _inputs(1, T, 0)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    loaded = load_into_model(model, sd, audio, faces)
    a, b = _flat(loaded), _flat(variables)
    assert sorted(a) == sorted(b)
    for k in b:
        assert np.array_equal(np.asarray(a[k]), b[k]), k


def test_scorer_and_asd_experiment_match_jax(jax_talknet, tmp_path):
    from speaker3d_tpu.diar.video import make_talknet_asd_scorer
    from speaker3d_tpu.utils.checkpoint import Checkpointer

    _, variables, port = jax_talknet
    audio, faces = _inputs(1, 12, 3)
    want = make_talknet_asd_scorer(variables)(audio[0], faces[0])
    got = tvideo.make_talknet_asd_scorer(port.state_dict(), device="cpu")(
        audio[0], faces[0])
    assert got.shape == want.shape == (12,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # an experiment in the JAX ASD trainer's layout
    Checkpointer(str(tmp_path / "models")).save_checkpoint(
        1, {"asd_state": {**variables, "step": np.asarray(0, np.int32)}})
    model = ttalknet.load_talknet_exp(str(tmp_path))
    got2 = tvideo.make_talknet_asd_scorer(None, device="cpu", model=model)(
        audio[0], faces[0])
    np.testing.assert_array_equal(got2, got)
    with pytest.raises(FileNotFoundError):
        ttalknet.load_talknet_exp(str(tmp_path / "none"))
    assert state_dict_from_flax(variables).keys() == port.state_dict().keys()
    assert os.path.isdir(tmp_path / "models")
