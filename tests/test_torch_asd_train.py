"""The port's TalkNet ASD trainer (``data/dataset_asd.py``,
``train/asd_train.py``, ``cli/train_asd.py``) against the JAX package's.

- The loader: after the same ``set_seed``, the init draw of ``train_data[0]``
  and two epochs in the CLI's ``default_rng(epoch)`` order, every
  ``TrainData`` and ``ValData`` item of the port is byte-equal to the JAX
  loader's, on an AVA-layout corpus of jpgs written with ``cv2.imwrite``
  (``tests/test_asd_data.py``'s fixture) with clips of three lengths.
- Three train steps of the real TalkNet at B = 2, T = 4 (the visual
  frontend's 3-D convolution reads the neighbouring clip's frames at the
  clip boundary), from one JAX ``init_asd_train_state`` that crosses over
  through the port's ``load_state_tree``, with ``step_per_epoch = 2`` so the
  lr staircase steps down in the third. In float64 (the JAX step under
  ``jax.enable_x64``, the port in double) every leaf of ``params``,
  ``batch_stats``, ``mu`` and ``nu`` lies within 1e-7 of its scale
  (max|want|), and the losses and scores within 1e-9. In float32 the random
  TalkNet's gradients are ill-conditioned leaf by leaf, as random ECAPA's
  were (``tests/test_torch_ssl.py``): training-mode BatchNorm's backward
  cancels, and Adam turns a near-zero gradient's rounding into an update
  of about ``lr`` with either sign (BatchNorm biases 99% of their size
  apart after three steps in either package's own fp32 step); so the fp32
  step is held on its losses against the float64 JAX losses: the first
  within 1e-5, the later two, which follow those updates, within 1e-2
  (the port's third lay 1.1e-3 from it; the JAX package's own fp32 step,
  1.0e-2).
  Held apart and named: the key third of each attention's
  ``in_proj_bias`` (``crossA2V``, ``crossV2A``: 128 entries; ``selfAV``:
  256) and ``visualConv1D.net.0.bias`` (a bias before a training-mode
  BatchNorm). Their gradients are zero but for rounding in both packages;
  in float64 that rounding is ~1e-17, far below Adam's eps, so they are
  checked to stay within 1e-12 of their start (params) and below 1e-12
  (mu) instead of against a scale they do not have.
- The lr: ``asd_lr`` within one ulp of the jitted JAX expression ``lr *
  power(lr_decay, epoch)`` for epochs 0-60 (XLA's fp32 power is itself up
  to an ulp off the float64 value rounded once).
- The initial weights: ``init_talknet`` draws each leaf kind from the
  Flax init's distribution (lecun-normal truncated at 2 sigma, xavier-
  uniform, constants), held against the JAX init's leaves by their spread.
- ``state_tree`` writes the JAX ``asd_state`` tree, raw torch-layout leaves
  included (``in_proj_*``, the PReLU's ``net.3.weight``, gLN's ``gamma`` /
  ``beta``), and reads it back.
- ``--test`` of each package on the other's one-epoch experiment prints the
  same ``mAP`` line as that package's own evaluation.
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.tree_util import keystr, tree_flatten_with_path

from tests.torch_threads import cap_torch_threads, worker_threads  # noqa: F401
from speaker3d_tpu.models.talknet import TalkNetModel as JaxTalkNet
from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu.train import asd_train as jtrain
from speaker3d_tpu_torch.models.talknet import TalkNetModel
from speaker3d_tpu_torch.train import asd_train
from speaker3d_tpu_torch.train.vad_train import init_adam_train_state
from speaker3d_tpu_torch.utils.threads import cpu_threads

FS = 16000
B, T = 2, 4
STEPS = 3
TOL64 = 1e-7
LOSS_TOL32 = 1e-5        # the first step's fp32 loss
LOSS_TOL32_LATER = 1e-2  # after fp32 updates (module docstring)
# zero gradient but for rounding (module docstring)
KEY_BIAS = {"crossA2V": 128, "crossV2A": 128, "selfAV": 256}
ROUNDING_ONLY = "['visualConv1D.net.0']['bias']"


def write_corpus(root, lengths, seed=0):
    """An AVA layout under ``root``: per clip an 11-character video id, a
    wav, jpg crops named by timestamp and a CSV row ``entity \\t frames \\t
    fps \\t [labels] \\t n``; returns (csv, audio_dir, video_dir)."""
    import cv2

    from speaker3d_tpu_torch.utils.fileio import write_wav

    rng = np.random.default_rng(seed)
    audio_dir = os.path.join(root, "clips_audios")
    video_dir = os.path.join(root, "clips_videos")
    rows = []
    for ci, n_frames in enumerate(lengths):
        video = f"vid{ci:08d}"
        clip = f"{video}_c{ci}"
        os.makedirs(os.path.join(audio_dir, video), exist_ok=True)
        os.makedirs(os.path.join(video_dir, video, clip), exist_ok=True)
        n = int(n_frames / 25.0 * FS)
        write_wav(os.path.join(audio_dir, video, clip + ".wav"),
                  (0.1 * rng.standard_normal(n)).astype(np.float32), FS)
        for f in range(n_frames):
            img = (rng.random((40, 40, 3)) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(video_dir, video, clip,
                                     f"{f * 0.04:.2f}.jpg"), img)
        labels = rng.integers(0, 2, n_frames)
        rows.append(f"{clip}\t{n_frames}\t25\t"
                    f"[{','.join(str(int(x)) for x in labels)}]\t{ci}")
    csv = os.path.join(root, "clips.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv, audio_dir, video_dir


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    pytest.importorskip("cv2")
    return write_corpus(str(tmp_path_factory.mktemp("asd_corpus")),
                        (6, 4, 4, 10))


def _loader_items(pkg, csv, audio_dir, video_dir):
    """The CLI's draws through ``pkg``'s loader: ``set_seed(1234)``, the init
    draw, two epochs in ``default_rng(epoch)`` order, then every val item."""
    if pkg == "jax":
        from speaker3d_tpu.data.dataset_asd import TrainData, ValData
        from speaker3d_tpu.utils.misc import set_seed
    else:
        from speaker3d_tpu_torch.data.dataset_asd import TrainData, ValData
        from speaker3d_tpu_torch.utils.misc import set_seed
    set_seed(1234)
    val = ValData(csv, audio_dir, video_dir)
    train = TrainData(csv, audio_dir, video_dir, 8)
    items = [train[0]]
    order = np.arange(len(train))
    for epoch in range(2):
        np.random.default_rng(epoch).shuffle(order)
        items += [train[int(i)] for i in order]
    return items + [val[i] for i in range(len(val))], len(train)


def test_loader_items_byte_equal_to_jax(corpus):
    want, n_batches = _loader_items("jax", *corpus)
    got, _ = _loader_items("port", *corpus)
    assert n_batches == 3  # 10 | 6 | 4, 4 frames: three shapes
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_lr_within_one_ulp_of_jax():
    for lr, decay in ((1e-4, 0.95), (5e-3, 0.9), (1e-3, 0.97)):
        cfg = asd_train.ASDTrainConfig(lr=lr, lr_decay=decay,
                                       step_per_epoch=3)
        fn = jax.jit(lambda e, lr=lr, decay=decay:
                     lr * jnp.power(decay, e.astype(jnp.float32)))
        want = np.array([np.asarray(fn(jnp.int32(e))) for e in range(61)],
                        np.float32)
        got = np.array([asd_train.asd_lr(3 * e + 2, cfg).item()
                        for e in range(61)], np.float32)
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32))
        assert ulps.max() <= 1, (lr, decay, ulps.max())


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return {"audio": rng.standard_normal((B, 4 * T, 13)).astype(np.float32)
            * 5,
            "visual": (rng.random((B, T, 112, 112)) * 255).astype(np.float32),
            "labels": rng.integers(0, 2, (B, T)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_init(batch):
    """One JAX ``init_asd_train_state`` (numpy leaves), its mesh and cfg."""
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    cfg = jtrain.ASDTrainConfig(step_per_epoch=2)
    state = jtrain.init_asd_train_state(
        jax.random.PRNGKey(0), JaxTalkNet(), batch["audio"][:1],
        batch["visual"][:1], cfg, mesh)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(state)), mesh, cfg


def _leaves(tree):
    return {keystr(k): np.asarray(v)
            for k, v in tree_flatten_with_path(tree)[0]}


def test_state_tree_round_trips_with_raw_leaves(jax_init):
    init, _, _ = jax_init
    state = init_adam_train_state(TalkNetModel(), "cpu")
    asd_train.load_state_tree(state, init)
    for name, m in state.adam_m.items():  # the moments land by name
        m.add_(float(len(name)))
    tree = asd_train.state_tree(state)
    want = _leaves(init)
    got = _leaves(tree)
    assert sorted(got) == sorted(want)
    raw = [k for k in got if k.startswith("['params']") and re.search(
        r"in_proj_weight|in_proj_bias|out_proj\.weight|out_proj\.bias"
        r"|net\.3\.weight|\['gamma'\]|\['beta'\]", k)]
    assert len(raw) == 3 * 4 + 5 * 3  # three attentions, five TCN blocks
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if not k.startswith("['mu']"):
            np.testing.assert_array_equal(g, w, err_msg=k)
    sd = dict(state.adam_m)
    mu = _leaves(tree["mu"])
    assert mu["['crossA2V']['self_attn']['in_proj_bias']"][0] == float(
        len("crossA2V.self_attn.in_proj_bias"))
    back = init_adam_train_state(TalkNetModel(), "cpu")
    asd_train.load_state_tree(back, tree)
    for name, m in back.adam_m.items():
        torch.testing.assert_close(m, sd[name], rtol=0, atol=0)
    for (n, p), (_, q) in zip(back.model.state_dict().items(),
                              state.model.state_dict().items()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    assert back.step == 0


def test_init_distributions_match_flax(jax_init):
    """Per leaf: the same constants where Flax's init is constant; else the
    same spread (std and max|x|) within 15% on leaves of >= 1,000 values."""
    init, _, _ = jax_init
    want = _leaves({"params": init["params"],
                    "batch_stats": init["batch_stats"]})
    model = asd_train.init_talknet(1234)
    from speaker3d_tpu_torch.models.talknet import flax_variables

    got = _leaves(flax_variables(model))
    assert sorted(got) == sorted(want)
    kinds = {"constant": 0, "random": 0}
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if np.all(w == w.reshape(-1)[0]):
            np.testing.assert_array_equal(g, w, err_msg=k)
            kinds["constant"] += 1
        elif w.size >= 1000:
            kinds["random"] += 1
            assert abs(g.std() / w.std() - 1) < 0.15, (k, g.std(), w.std())
            assert abs(np.abs(g).max() / np.abs(w).max() - 1) < 0.15, k
            assert abs(g.mean()) < 5 * w.std() / np.sqrt(w.size), k
    assert kinds == {"constant": 312, "random": 84}, kinds


@pytest.fixture(scope="module")
def jax_steps64(jax_init, batch):
    """Three JAX steps in float64: (state after them, losses, scores)."""
    init, mesh, cfg = jax_init
    with jax.enable_x64(True):
        init64 = jax.tree_util.tree_map(
            lambda x: x.astype(np.float64) if x.dtype == np.float32 else x,
            init)
        sharding = NamedSharding(mesh, P())
        state = jax.device_put(init64, jax.tree_util.tree_map(
            lambda _: sharding, init64))
        step = jtrain.make_asd_train_step(JaxTalkNet(), cfg, mesh, init64)
        batch64 = {"audio": batch["audio"].astype(np.float64),
                   "visual": batch["visual"].astype(np.float64),
                   "labels": batch["labels"]}
        losses, scores = [], []
        for _ in range(STEPS):
            state, m = step(state, batch64)
            losses.append(float(m["loss"]))
            scores.append(np.asarray(m["scores"]))
        return (jax.tree_util.tree_map(np.asarray, jax.device_get(state)),
                init64, losses, scores)


def _port_steps(init, batch, dtype):
    state = init_adam_train_state(TalkNetModel().to(dtype), "cpu")
    asd_train.load_state_tree(state, init)
    step = asd_train.make_asd_train_step(
        asd_train.ASDTrainConfig(step_per_epoch=2))
    tb = {"audio": torch.from_numpy(batch["audio"]).to(dtype),
          "visual": torch.from_numpy(batch["visual"]).to(dtype),
          "labels": torch.from_numpy(batch["labels"])}
    losses, scores, lrs = [], [], []
    with cpu_threads(worker_threads()):
        for _ in range(STEPS):
            m = step(state, tb)
            losses.append(m["loss"].item())
            scores.append(m["scores"].numpy())
            lrs.append(m["lr"].item())
    return state, losses, scores, lrs


def test_three_steps_match_jax(jax_steps64, batch):
    want_state, init64, want_losses, want_scores = jax_steps64
    state, losses, scores, lrs = _port_steps(init64, batch, torch.float64)
    assert lrs[0] == lrs[1] == np.float32(1e-4)
    assert lrs[2] == pytest.approx(0.95e-4, rel=1e-7)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-9)
    for g, w in zip(scores, want_scores):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    assert state.step == STEPS
    want = _leaves(want_state)
    got = _leaves(asd_train.state_tree(state))
    start = _leaves(init64)
    assert sorted(got) == sorted(want)
    held = []
    for k, w in want.items():
        g = got[k].astype(np.float64)
        if k.endswith(ROUNDING_ONLY) or k.endswith("['in_proj_bias']"):
            if k.endswith("['in_proj_bias']"):
                attn = re.search(r"\['(\w+)'\]\['self_attn'\]", k).group(1)
                d = KEY_BIAS[attn]
                keys = slice(d, 2 * d)
                rest = np.r_[0:d, 2 * d:3 * d]
                scale = max(np.abs(w[rest]).max(), 1e-12)
                assert np.abs(g[rest] - w[rest]).max() <= TOL64 * scale, k
                g, w, s = g[keys], w[keys], start[k][keys]
            else:
                s = start[k]
            held.append(k)
            if k.startswith("['params']"):
                assert np.abs(g - s).max() < 1e-12, k
                assert np.abs(w - s).max() < 1e-12, k
            elif k.startswith("['mu']"):
                assert np.abs(g).max() < 1e-12 and np.abs(w).max() < 1e-12, k
            continue
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= TOL64 * scale, (k, np.abs(g - w).max(),
                                                      scale)
    assert len(held) == 3 * (3 + 1), held  # params, mu, nu of each

    # float32, the port's own path: the losses against the float64 JAX ones
    _, losses32, _, _ = _port_steps(
        jax.tree_util.tree_map(
            lambda x: x.astype(np.float32) if x.dtype == np.float64 else x,
            init64), batch, torch.float32)
    np.testing.assert_allclose(losses32[0], want_losses[0], rtol=LOSS_TOL32)
    np.testing.assert_allclose(losses32, want_losses, rtol=LOSS_TOL32_LATER)


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    """Two clips of one length (one batch shape: one JAX compile)."""
    pytest.importorskip("cv2")
    return write_corpus(str(tmp_path_factory.mktemp("asd_cli")), (4, 4),
                        seed=1)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), cpu_threads(worker_threads()):
        main(argv)
    return out.getvalue()


def _cli_argv(cli_corpus, exp):
    csv, audio_dir, video_dir = cli_corpus
    return ["--train_csv", csv, "--val_csv", csv, "--audio_dir", audio_dir,
            "--video_dir", video_dir, "--exp_dir", exp, "--batch_size", "8",
            "--epochs", "1"]


def _epoch_map(out):
    return re.search(r"^epoch 1: loss [\d.]+ val mAP ([\d.]+)%", out,
                     re.M).group(1)


def test_port_test_reads_the_jax_experiment(cli_corpus, tmp_path):
    from speaker3d_tpu.cli.train_asd import main as jmain
    from speaker3d_tpu_torch.cli.train_asd import main as pmain

    exp = str(tmp_path / "exp_jax")
    want = _epoch_map(_run(jmain, _cli_argv(cli_corpus, exp)))
    got = _run(pmain, _cli_argv(cli_corpus, exp) + ["--test", "--device",
                                                    "cpu"])
    assert got.strip() == f"mAP: {want}%"


def test_jax_test_reads_the_port_experiment(cli_corpus, tmp_path):
    from speaker3d_tpu.cli.train_asd import main as jmain
    from speaker3d_tpu_torch.cli.train_asd import main as pmain

    exp = str(tmp_path / "exp_port")
    out = _run(pmain, _cli_argv(cli_corpus, exp) + ["--device", "cpu"])
    assert re.search(r"^epoch 1: 1 steps of 8, step [\d.]+ ms", out,
                     re.M), out
    assert os.path.isdir(os.path.join(exp, "models", "CKPT-EPOCH-1-00"))
    mine = _run(pmain, _cli_argv(cli_corpus, exp) + ["--test", "--device",
                                                     "cpu"])
    assert mine.strip() == f"mAP: {_epoch_map(out)}%"
    theirs = _run(jmain, _cli_argv(cli_corpus, exp) + ["--test"])
    assert theirs.strip() == mine.strip()
    from speaker3d_tpu_torch.models.talknet import load_talknet_exp

    assert isinstance(load_talknet_exp(exp), TalkNetModel)
