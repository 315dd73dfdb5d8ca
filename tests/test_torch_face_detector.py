"""The port's face detector and its trainer against the JAX package's on
the CPU: rendered frames byte-equal for the same seed; ``gaussian_heatmap``
and ``decode_detections`` equal; the forward at 1e-5 of its scale on
random weights with BatchNorm statistics near 0, at an even and an odd
frame size (Flax's SAME padding at stride 2 pads (0, 1) on an even size);
``detector_loss`` and its gradients against ``jax.value_and_grad``; three
steps of the port's train step against the JAX CLI's own run from the same
initial weights and batches (every leaf of ``train_state`` within 1e-4 of
its scale; fp32 suffices here: measured within 1e-5); and experiments
across the packages: the JAX loader reads the port CLI's experiment, the
port's loader and CLI read and resume the JAX CLI's, with equal boxes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_threads import cap_torch_threads  # noqa: F401
from speaker3d_tpu.cli import train_face_detector as jcli
from speaker3d_tpu.data import synthetic_faces as jfaces
from speaker3d_tpu.models import face_detector as jfd
from speaker3d_tpu_torch.cli import train_face_detector as tcli
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.data import synthetic_faces as tfaces
from speaker3d_tpu_torch.models import face_detector as tfd
from speaker3d_tpu_torch.train import vad_train as tvt

# batch 3: the JAX CLI shards its batch over gcd(batch, devices) of the
# tests' 8 virtual CPU devices, and its BatchNorms take their statistics
# per shard; at an odd batch it runs on one device, as the port runs on one
# card
SMALL = {"height": 48, "width": 64, "batch_size": 3, "step_per_epoch": 3,
         "model": {"args": {"channels": 8}}}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, rel):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for key in w:
        scale = max(float(np.abs(w[key]).max()), 1e-12)
        err = float(np.abs(g[key] - w[key]).max())
        assert err <= rel * scale, (key, err, scale)


def _jax_variables(channels, h, w, seed):
    model = jfd.TinyFaceDetector(channels=channels)
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(seed), np.zeros((1, h, w, 1), np.float32)))
    rng = np.random.default_rng(seed + 1)
    stats = {name: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)
                             ).astype(np.float32),
                    "var": (rng.random(s["var"].shape) + 0.5
                            ).astype(np.float32)}
             for name, s in v["batch_stats"].items()}
    return model, {"params": v["params"], "batch_stats": stats}


def _port_model(variables, channels):
    model = tfd.TinyFaceDetector(channels=channels)
    model.load_state_dict(state_dict_from_flax(variables,
                                               like=model.state_dict()),
                          strict=True)
    return model.eval()


def test_rendered_frames_byte_equal():
    for seed in range(4):
        jf, jb = jfaces.render_frame(np.random.default_rng(seed))
        tf, tb = tfaces.render_frame(np.random.default_rng(seed))
        assert jf.dtype == tf.dtype and jf.tobytes() == tf.tobytes()
        assert jb == tb
    jv, jboxes = jfaces.render_moving_face_video(np.random.default_rng(5), 12)
    tv, tboxes = tfaces.render_moving_face_video(np.random.default_rng(5), 12)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(jv, tv))
    assert jboxes == tboxes
    # the port draws each face on its box only: faces inside, across the
    # edges, at fractional positions and outside the frame
    for box in ((10, 5, 30, 38), (-12, -7, 30, 38), (60.5, 40.25, 31, 37),
                (70, 50, 30, 40), (200, 3, 20, 20)):
        a, b = np.full((60, 80), 40.0), np.full((60, 80), 40.0)
        jfaces.render_face(a, *box, brightness=190.0)
        tfaces.render_face(b, *box, brightness=190.0)
        assert a.tobytes() == b.tobytes(), box


def test_heatmap_and_decode_equal():
    boxes = [(40, 24, 32, 40), (120, 80, 40, 48), (-5, 130, 20, 30)]
    for got, want in zip(tfd.gaussian_heatmap(144, 192, boxes),
                         jfd.gaussian_heatmap(144, 192, boxes)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    rng = np.random.default_rng(0)
    for _ in range(5):
        logits = rng.normal(-1.0, 2.0, (18, 24)).astype(np.float32)
        sizes = rng.uniform(8, 60, (18, 24, 2)).astype(np.float32)
        for thr in (0.3, 0.6):
            assert (tfd.decode_detections(logits, sizes, threshold=thr)
                    == jfd.decode_detections(logits, sizes, threshold=thr))


@pytest.mark.parametrize("h,w", [(48, 64), (43, 61)])
def test_forward_matches_jax(h, w):
    model, variables = _jax_variables(8, h, w, seed=2)
    x = np.random.default_rng(3).random((2, h, w, 1)).astype(np.float32)
    want = [np.asarray(a) for a in model.apply(variables, x)]
    with torch.no_grad():
        got = [a.numpy() for a in _port_model(variables, 8)(torch.from_numpy(x))]
    for g, wt in zip(got, want):
        assert g.shape == wt.shape
        np.testing.assert_allclose(g, wt, rtol=0,
                                   atol=1e-5 * np.abs(wt).max())


def test_loss_and_gradients_match_jax():
    rng = np.random.default_rng(4)
    targets = [tfd.gaussian_heatmap(48, 64, [(8, 6, 20, 26), (36, 12, 18, 24)])
               for _ in range(2)]
    heat, size, mask = (np.stack(t) for t in zip(*targets))
    logits = rng.normal(-1.0, 1.5, heat.shape).astype(np.float32)
    sizes = rng.uniform(4, 40, size.shape).astype(np.float32)

    def jloss(lg, sz):
        loss, hl, sl = jfd.detector_loss(lg, sz, heat, size, mask)
        return loss, (hl, sl)

    (jl, (jh, js)), (jg_l, jg_s) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                             jnp.asarray(sizes))
    tl_in = torch.tensor(logits, requires_grad=True)
    ts_in = torch.tensor(sizes, requires_grad=True)
    tl, th, ts = tfd.detector_loss(tl_in, ts_in, torch.from_numpy(heat),
                                   torch.from_numpy(size),
                                   torch.from_numpy(mask))
    tl.backward()
    for g, w in ((tl, jl), (th, jh), (ts, js)):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    for g, w in ((tl_in.grad, jg_l), (ts_in.grad, jg_s)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _write_config(root, name, **extra):
    cfg = {"exp_dir": os.path.join(root, name), **SMALL, **extra}
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


@pytest.fixture(scope="module")
def jax_exp(tmp_path_factory):
    """The JAX CLI's run: one epoch of three steps at seed 3."""
    root = str(tmp_path_factory.mktemp("face_det"))
    cfg, path = _write_config(root, "jexp", num_epoch=1, warmup_epoch=1)
    jcli.main(["--config", path, "--seed", "3"])
    return root, cfg, path


def _latest(exp_dir):
    from speaker3d_tpu.utils.checkpoint import Checkpointer

    return Checkpointer(os.path.join(exp_dir, "models")
                        ).recover_if_possible()["train_state"]


def test_three_steps_match_the_jax_cli(jax_exp):
    """The JAX CLI's initial weights (its ``model.init`` at the seed) and
    batches (its generator at the seed) through the port's step."""
    _, cfg, _ = jax_exp
    h, w = cfg["height"], cfg["width"]
    jmodel = jfd.TinyFaceDetector(channels=8)
    init = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init, static_argnames=("train",))(
            jax.random.PRNGKey(3), np.zeros((1, h, w, 1), np.float32),
            train=True))
    model = tfd.TinyFaceDetector(channels=8)
    model.load_state_dict(state_dict_from_flax(init, like=model.state_dict()),
                          strict=True)
    state = tvt.init_adam_train_state(model, "cpu")
    step = tcli.make_detector_train_step(tcli.train_config(cfg))
    make_batch = tcli.make_batch_fn(cfg)
    rng = np.random.default_rng(3)
    for _ in range(3):
        metrics = step(state, {k: torch.from_numpy(v)
                               for k, v in make_batch(rng).items()})
        assert np.isfinite(float(metrics["loss"]))
    want = _latest(cfg["exp_dir"])
    assert int(want["step"]) == 3
    _assert_trees_close(tvt.state_tree(state), want, 1e-4)


def test_batches_byte_equal_to_the_jax_cli(jax_exp, monkeypatch):
    """The port's ``make_batch`` against the JAX CLI's (captured from its
    ``device_prefetch``) for the same seed."""
    from speaker3d_tpu.data import prefetch as jprefetch

    root, cfg, path = jax_exp
    seen = []
    real = jprefetch.device_prefetch

    def capture(gen, **kw):
        batches = list(gen)
        seen.extend(batches)
        return real(iter(batches), **kw)

    monkeypatch.setattr(jprefetch, "device_prefetch", capture)
    cfg2, path2 = _write_config(root, "jexp_batches", num_epoch=1)
    jcli.main(["--config", path2, "--seed", "5"])
    make_batch = tcli.make_batch_fn(cfg2)
    rng = np.random.default_rng(5)
    assert len(seen) == 3
    for want in seen:
        got = make_batch(rng)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def test_experiments_across_the_packages(jax_exp, tmp_path, capsys):
    """The port loads the JAX CLI's experiment and resumes it; the JAX
    loader reads the port CLI's; both loaders decode the same boxes."""
    _, cfg, _ = jax_exp
    frames = [tfaces.render_frame(np.random.default_rng(s), 48, 64)[0]
              for s in range(3)]

    def same_boxes(exp_dir):
        tdet = tfd.load_face_detector_exp(exp_dir, threshold=0.05,
                                          device="cpu")
        jdet = jfd.load_face_detector_exp(exp_dir, threshold=0.05)
        n = 0
        for frame in frames:
            got, want = tdet(frame), jdet(frame)
            assert len(got) == len(want)
            np.testing.assert_allclose(np.asarray(got).reshape(-1, 4),
                                       np.asarray(want).reshape(-1, 4),
                                       atol=1e-3)
            n += len(got)
        return n

    same_boxes(cfg["exp_dir"])
    # the port CLI resumes the JAX experiment: one more epoch
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    import shutil

    shutil.copytree(cfg["exp_dir"], resumed, dirs_exist_ok=True)
    _, path = _write_config(str(tmp_path), "resume", num_epoch=2,
                            exp_dir=resumed)
    tcli.main(["--config", path, "--seed", "3", "--device", "cpu"])
    assert "recovered from epoch 1" in capsys.readouterr().out
    tree = _latest(resumed)
    assert int(tree["step"]) == 6
    same_boxes(resumed)
    # a fresh port experiment, which the JAX loader reads
    _, path = _write_config(str(tmp_path), "port", num_epoch=2)
    tcli.main(["--config", path, "--seed", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "epoch 2 avg_loss" in out and "samples/s" in out
    port_exp = str(tmp_path / "port")
    tree = _latest(port_exp)
    assert sorted(tree) == ["adam_m", "adam_v", "batch_stats", "params",
                            "step"]
    assert int(tree["step"]) == 6
    same_boxes(port_exp)
    with open(os.path.join(port_exp, "train_epoch.log")) as f:
        assert len(f.read().strip().splitlines()) == 2
