"""The port's SV train step against the JAX ``make_sv_train_step``.

The JAX step runs on a 1x1 mesh (one device holds the batch and every
class) with ``feature_fn=KaldiFbank(mean_norm=True)``, the port's on the
CPU with its own ``KaldiFbank``; both start from the same converted weights
and ``cls_w``, with the step counter inside the lr warm-up and inside the
margin ramp. Per step the loss, accuracy, lr and margin agree at rtol
1e-4; after three steps the parameters, ``cls_w`` and BatchNorm running
statistics agree at atol 1e-4, and the SGD buffers at 1e-4 of their scale
(each buffer's on the same features, the largest buffer's with each
package's own fbank). The int16 wire gives what float32
gives, and per-block remat what the plain step gives, running statistics
included.
"""

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu.ops.fbank import FbankConfig as JaxFbankConfig
from speaker3d_tpu.ops.fbank import KaldiFbank as JaxKaldiFbank
from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu.train import sv_train as jsv
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.train import sv_train as tsv
from tests.test_torch_eres2netv2 import jax_variables

SMALL = dict(num_blocks=(1, 1, 1, 1), m_channels=8, feat_dim=80,
             embedding_size=32)
NUM_CLASSES = 6
# 10 steps per epoch: warm-up runs to step 50, the margin ramps over steps
# 10-80; every compared step (20-22) lies inside both. This small random
# model's loss is sharp: a weight change of 1e-3 moves bn1.bias's gradient by
# O(1), so the two packages' fbank rounding (up to 2e-5 in log-mel on these
# broadband batches, 1e-4 in the low-power bins of near-tonal ones) grows
# step by step. At the config's peak lr 0.2 (0.08 at step 20) the weights
# move by up to 1.7 per step and differ by 6e-3 after three steps; at a peak
# of 0.001 (4.6e-4 at step 20) they differ by ~1e-6.
SCHED = dict(num_classes=NUM_CLASSES, embedding_size=32, step_per_epoch=10,
             warmup_epoch=5, fix_epoch=12, increase_start_epoch=1,
             margin_fix_epoch=8, final_margin=0.3, max_lr=0.001)
START = 20
TOL = 1e-4


def _batches(n=3, b=4, samples=8000, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = np.arange(samples) / 16000
        f0 = rng.uniform(100, 400, (b, 1))
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.3 * rng.standard_normal((b, samples)))
        pcm = np.round(np.clip(wav, -1, 1 - 1 / 32768) * 32768) / 32768
        out.append({"wavs": pcm.astype(np.float32),
                    "labels": rng.integers(0, NUM_CLASSES, b).astype(np.int32)})
    return out


@pytest.fixture(scope="module")
def start():
    jmodel = JaxERes2NetV2(**SMALL)
    variables = jax_variables(jmodel)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    cfg = jsv.SVTrainConfig(**SCHED)
    state = jsv.init_sv_train_state(
        jax.random.PRNGKey(0), jmodel, np.zeros((1, 48, 80), np.float32),
        cfg, mesh, backbone_variables=variables)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(state))
    host["step"] = np.asarray(START, np.int32)
    return jmodel, mesh, cfg, host


def _jax_run(start, batches, fbank=True):
    jmodel, mesh, cfg, host = start
    step = jsv.make_sv_train_step(
        jmodel, cfg, mesh, host,
        feature_fn=(JaxKaldiFbank(JaxFbankConfig(), mean_norm=True)
                    if fbank else None))
    state = jax.device_put(host, jsv.state_shardings(host, mesh))
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree_util.tree_map(np.asarray, jax.device_get(state)), metrics


def _port_state(host, remat=False, fbank=True):
    model = ERes2NetV2(**SMALL)
    model.load_state_dict(state_dict_from_flax(
        {"params": host["params"], "batch_stats": host["batch_stats"]}),
        strict=True)
    cfg = tsv.SVTrainConfig(**SCHED, remat=remat)
    state = tsv.init_sv_train_state(model, cfg, device="cpu",
                                    cls_w=host["cls_w"])
    state.step = int(host["step"])
    feature_fn = (KaldiFbank(FbankConfig(), mean_norm=True, device="cpu")
                  if fbank else None)
    return state, tsv.make_sv_train_step(model, cfg, feature_fn=feature_fn)


def _port_run(host, batches, remat=False, wire=None):
    state, step = _port_state(host, remat, fbank="wavs" in batches[0])
    metrics = []
    for batch in batches:
        if "feats" in batch:
            m = step(state, {k: torch.tensor(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            continue
        wavs = batch["wavs"]
        if wire == "int16":
            wavs = np.clip(np.rint(wavs * 32768.0), -32768, 32767).astype(
                np.int16)
        m = step(state, {"wavs": torch.from_numpy(wavs),
                         "labels": torch.from_numpy(batch["labels"])})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _assert_states_match(state, want_state, mom_tol):
    sd = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    want_sd = state_dict_from_flax({"params": want_state["params"],
                                    "batch_stats": want_state["batch_stats"]})
    assert sorted(sd) == sorted(want_sd)
    for k, v in want_sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k], v.numpy(), rtol=0, atol=TOL,
                                       err_msg=k)
    np.testing.assert_allclose(state.cls_w.detach().numpy(),
                               want_state["cls_w"], rtol=0, atol=TOL)
    want_mom = state_dict_from_flax({"params": want_state["momentum"]["params"]})
    want_mom = {k: v.numpy() for k, v in want_mom.items()}
    want_mom["cls_w"] = want_state["momentum"]["cls_w"]
    got_mom = {k: v.numpy() for k, v in state.momentum["model"].items()}
    got_mom["cls_w"] = state.momentum["cls_w"].numpy()
    assert sorted(got_mom) == sorted(want_mom)
    for k, v in want_mom.items():
        np.testing.assert_allclose(got_mom[k], v, rtol=0, atol=mom_tol(v),
                                   err_msg=k)
    return sd


def _jax_features(batches):
    fbank = JaxKaldiFbank(JaxFbankConfig(), mean_norm=True)
    return [{"feats": np.asarray(fbank(b["wavs"])), "labels": b["labels"]}
            for b in batches]


def test_three_steps_match_the_jax_step(start):
    """Each package with its own fbank. An SGD buffer is a sum of
    gradients (up to ~30 here), and the fbanks' rounding moves this sharp
    model's gradients by up to ~1e-4 of their size, so the buffers are held
    at TOL of the largest buffer; the next test holds them per buffer on
    the same features."""
    batches = _batches()
    want_state, want = _jax_run(start, batches)
    state, got = _port_run(start[3], batches)
    assert state.step == START + 3 == int(want_state["step"])
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "acc", "lr", "margin"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    assert 1e-4 < got[0]["lr"] < 0.001 and 0 < got[0]["margin"] < 0.3
    top = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(
        want_state["momentum"]))
    assert top > 1.0
    sd = _assert_states_match(state, want_state, lambda v: TOL * top)
    # the steps moved the weights and the statistics
    start_sd = state_dict_from_flax(
        {"params": start[3]["params"], "batch_stats": start[3]["batch_stats"]})
    for k in ("conv1.weight", "bn1.running_mean", "layer4.0.bn3.running_var"):
        assert np.abs(sd[k] - start_sd[k].numpy()).max() > 1e-4, k


def test_three_steps_on_the_same_features_match_the_jax_step(start):
    """The JAX fbank's features into both steps: the rest of the step (the
    backbone in train mode, classifier, loss, SGD) holds every SGD buffer
    at TOL of its own scale."""
    batches = _jax_features(_batches())
    want_state, want = _jax_run(start, batches, fbank=False)
    state, got = _port_run(start[3], batches)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    _assert_states_match(state, want_state,
                         lambda v: TOL * max(1.0, float(np.abs(v).max())))


def test_int16_wire_equals_float32(start):
    batches = _batches(n=2, seed=1)
    s32, m32 = _port_run(start[3], batches)
    s16, m16 = _port_run(start[3], batches, wire="int16")
    assert m32 == m16
    for (k, a), b in zip(s32.model.state_dict().items(),
                         s16.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_remat_equals_plain(start):
    batches = _batches(n=2, seed=2)
    plain, mp = _port_run(start[3], batches)
    remat, mr = _port_run(start[3], batches, remat=True)
    assert remat.model.remat and not plain.model.remat
    for a, b in zip(mp, mr):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6)
    for (k, a), b in zip(plain.model.state_dict().items(),
                         remat.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    # the backward's recomputation did not count as a second update
    assert int(remat.model.bn1.num_batches_tracked) == 2
    assert int(remat.model.layer1[0].bn1.num_batches_tracked) == 2


def test_unported_options_are_refused():
    model = ERes2NetV2(**SMALL)
    cfg = tsv.SVTrainConfig(num_classes=4)
    with pytest.raises(NotImplementedError, match="bf16"):
        tsv.make_sv_train_step(model, cfg._replace(compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="M14"):
        tsv.make_sv_train_step(model, cfg, model_parallel=2)
    from speaker3d_tpu_torch.models.campplus import CAMPPlus

    with pytest.raises(NotImplementedError, match="CAMPPlus.*remat"):
        tsv.make_sv_train_step(CAMPPlus(feat_dim=80, embedding_size=32),
                               cfg._replace(remat=True))
