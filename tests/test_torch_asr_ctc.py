"""The port's CTC loss, train step and greedy decoding against the JAX
package's ``asr/ctc.py``.

The CTC loss and its gradient with respect to the logits match
``optax.ctc_loss`` (padded, repeated and empty label sequences) at 1e-5.
Three train steps from one state and one set of batches match
``make_ctc_train_step`` on a one-device CPU mesh: loss and lr per step at
rtol 1e-4, then every parameter at atol 1e-4 and both Adam moments at 1e-4
of each tensor's largest entry, with each package's own fbank and on the
same features. The key third of each ``linear_q_k_v`` bias is held apart:
a bias on the keys adds one constant to each query's scores, which the
softmax removes, so its gradient is zero but for rounding (~1e-10 here,
against ~1e-3 on the queries' third) and Adam scales that noise up to
updates of ~lr in either package; both packages' first moments of it must
be rounding noise. The port's steps run at a stated CPU thread count
(``PORT_THREADS``). Greedy decoding and the ASR triple are equal on seeded
logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speaker3d_tpu.asr import ctc as jctc
from speaker3d_tpu.ops.fbank import FbankConfig as JaxFbankConfig
from speaker3d_tpu.ops.fbank import KaldiFbank as JaxKaldiFbank
from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu_torch.asr import ctc as tctc
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.train import vad_train
from speaker3d_tpu_torch.utils.threads import cpu_threads
from tests.torch_threads import cap_torch_threads  # noqa: F401

TOL = 1e-4
PORT_THREADS = 2
MODEL = dict(vocab_size=4, feat_dim=80, d_model=32, num_heads=2, ffn_dim=64,
             num_layers=2, kernel_size=7, lfr_m=5, lfr_n=4)
# 10 steps an epoch: warm-up to step 10, the cosine to 40; steps 12-14
SCHED = dict(min_lr=1e-5, max_lr=2e-3, warmup_epoch=1, fix_epoch=4,
             step_per_epoch=10)
START = 12


def _labels(rng, b, u, vocab):
    lens = rng.integers(0, u + 1, b).astype(np.int32)
    lens[0], lens[1] = u, 0  # one full and one empty sequence
    labels = np.zeros((b, u), np.int32)
    for i, n in enumerate(lens):
        labels[i, :n] = rng.integers(1, vocab + 1, n)
    labels[0, :2] = labels[0, 0]  # a repeat needs a blank between
    return labels, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_and_gradient_equal_optax(seed):
    rng = np.random.default_rng(seed)
    b, t, u, v = 5, 24, 6, 7
    logits = (2 * rng.standard_normal((b, t, v + 1))).astype(np.float32)
    labels, lens = _labels(rng, b, u, v)
    pad = (np.arange(u)[None] >= lens[:, None]).astype(np.float32)

    def jax_loss(x):
        per = optax.ctc_loss(x, jnp.zeros((b, t)), labels, pad, blank_id=0)
        norm = jnp.maximum(lens.astype(np.float32), 1.0)
        return jnp.sum(per / norm) / b, per

    (want, want_per), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got_per = tctc.ctc_loss_per_seq(x, torch.from_numpy(labels),
                                    torch.from_numpy(lens))
    got, acc = tctc.ctc_loss(x, {"labels": torch.from_numpy(labels),
                                 "label_lens": torch.from_numpy(lens)})
    (grad,) = torch.autograd.grad(got, x)
    assert acc is None
    np.testing.assert_allclose(got_per.detach().numpy(), want_per, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0, atol=1e-5)


def _tone_batches(n=3, b=4, samples=16000, u=3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000
    out = []
    for _ in range(n):
        f0 = rng.uniform(300, 1800, (b, 1))
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               * (np.sin(2 * np.pi * rng.uniform(1, 3, (b, 1)) * t) > 0)
               + 0.01 * rng.standard_normal((b, samples)))
        labels, lens = _labels(rng, b, u, MODEL["vocab_size"])
        out.append({"wavs": wav.astype(np.float32), "labels": labels,
                    "label_lens": lens})
    return out


@pytest.fixture(scope="module")
def start():
    jm = jctc.SANMCTC(**MODEL)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    state = jctc.init_ctc_train_state(jax.random.PRNGKey(0), jm,
                                      np.zeros((1, 98, 80), np.float32), mesh)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(state))
    host["step"] = np.asarray(START, np.int32)
    return jm, mesh, host


def _jax_run(start, batches, fbank):
    jm, mesh, host = start
    feature_fn = None
    if fbank:
        fb = JaxKaldiFbank(JaxFbankConfig(), mean_norm=False)
        feature_fn = lambda w: fb(w) / 4.0 - 2.0  # noqa: E731 - a CMVN
    step = jctc.make_ctc_train_step(jm, jctc.CTCTrainConfig(**SCHED), mesh,
                                    host, feature_fn=feature_fn)
    state = jax.device_put(host)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree_util.tree_map(np.asarray, jax.device_get(state)), metrics


def _port_run(start, batches, fbank):
    _, _, host = start
    model = tctc.SANMCTC(**MODEL)
    state = vad_train.init_adam_train_state(model, "cpu")
    vad_train.load_state_tree(state, host)
    feature_fn = None
    if fbank:
        fb = KaldiFbank(FbankConfig(), mean_norm=False, device="cpu")
        feature_fn = lambda w: fb(w) / 4.0 - 2.0  # noqa: E731
    step = tctc.make_ctc_train_step(tctc.CTCTrainConfig(**SCHED), feature_fn)
    metrics = []
    with cpu_threads(PORT_THREADS):
        for batch in batches:
            m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return vad_train.state_tree(state), metrics


def _jax_features(batches):
    fb = JaxKaldiFbank(JaxFbankConfig(), mean_norm=False)
    return [{"feats": np.asarray(fb(b["wavs"])) / 4.0 - 2.0,
             **{k: b[k] for k in ("labels", "label_lens")}} for b in batches]


@pytest.mark.parametrize("inputs", ["own_fbank", "same_features"])
def test_three_steps_match_the_jax_step(start, inputs):
    batches = _tone_batches()
    fbank = inputs == "own_fbank"
    if not fbank:
        batches = _jax_features(batches)
    want_state, want = _jax_run(start, batches, fbank)
    got_state, got = _port_run(start, batches, fbank)
    assert int(got_state["step"]) == int(want_state["step"]) == START + 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "lr"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    assert 1e-3 < got[0]["lr"] < 2e-3 and got[0]["loss"] > 0.1
    host = start[2]
    d = MODEL["d_model"]
    for key in ("params", "adam_m", "adam_v"):
        paths = jax.tree_util.tree_flatten_with_path(want_state[key])[0]
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(
            got_state[key])[0])
        assert sorted(map(str, got_leaves)) == sorted(str(p) for p, _ in paths)
        for path, w in paths:
            g = got_leaves[path]
            if "'linear_q_k_v'" in str(path) and "'bias'" in str(path):
                if key == "adam_m":  # the key third: rounding noise in both
                    for m in (g, w):
                        assert np.abs(m[d:2 * d]).max() < 1e-6 * np.abs(
                            np.concatenate([m[:d], m[2 * d:]])).max(), path
                g, w = (np.concatenate([x[:d], x[2 * d:]]) for x in (g, w))
            if key == "params":
                np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                           err_msg=str(path))
            else:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=TOL * float(np.abs(w).max()),
                    err_msg=f"{key} {path}")
    # the steps moved the weights (Adam: by ~lr each step)
    before = state_dict_from_flax({"params": host["params"]})
    after = state_dict_from_flax({"params": got_state["params"]})
    moved = [float((after[k] - before[k]).abs().max()) for k in before]
    assert np.median(moved) > 10 * TOL


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_greedy_decode_and_asr_result_equal(seed):
    rng = np.random.default_rng(seed)
    vocab = ["bip", "bop", "beep", "你好"]
    # runs of frames, blanks among them, some tokens repeated across a blank
    frames = np.repeat(rng.integers(0, len(vocab) + 1, 30),
                       rng.integers(1, 5, 30))
    logits = rng.standard_normal((len(frames), len(vocab) + 1)).astype(
        np.float32)
    logits[np.arange(len(frames)), frames] += 6.0
    got = tctc.greedy_decode(logits, 0.04)
    want = jctc.greedy_decode(logits, 0.04)
    assert got == want and len(got) > 5
    assert tctc.tokens_to_asr_result(got, vocab) == \
        jctc.tokens_to_asr_result(want, vocab)
    assert tctc.tokens_to_asr_result([], vocab) == \
        jctc.tokens_to_asr_result([], vocab)
