"""The port's ``build_feature_fn`` and ``predict_label`` against the JAX
package's.

``build_feature_fn`` gives the JAX one's log-mel features at the fbank
tolerance of ``tests/test_torch_fbank.py`` (rtol = atol = 1e-4). Both
``predict_label`` CLIs write the same predictions file and print the same
accuracy line on a tiny ERes2NetV2 experiment
trained by the JAX ``cli.train`` and on one trained by the port's; the JAX
CLI reads the port's weights from a copy of that experiment in the JAX
trainer's checkpoint layout (``params``, ``batch_stats``, ``cls_w``),
converted by the JAX package's ``convert_torch_state_dict``. The module
runs at the xdist worker's share of the cores (``tests/torch_threads.py``).
"""

import os
import shutil

import jax
import numpy as np
import pytest

from speaker3d_tpu.cli import predict_label as jcli
from speaker3d_tpu.eval.embedding import build_feature_fn as j_features
from speaker3d_tpu_torch.cli import predict_label as tcli
from speaker3d_tpu_torch.eval.embedding import build_feature_fn as t_features
from tests.test_torch_train_cli import _config, _corpus
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000


@pytest.mark.parametrize("mean_norm", [True, False])
@pytest.mark.parametrize("shape", [(2 * FS,), (3, FS + 123)])
def test_feature_fn_equals_jax(mean_norm, shape):
    rng = np.random.default_rng(len(shape))
    t = np.arange(shape[-1]) / FS
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)
           + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    got = t_features(mean_norm=mean_norm, device="cpu")(wav).numpy()
    want = np.asarray(j_features(mean_norm=mean_norm)(wav))
    assert got.shape == want.shape == shape[:-1] + (
        1 + (shape[-1] - 400) // 160, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _label_files(root, rows):
    with open(os.path.join(root, "utt2lang"), "w") as f:
        f.writelines(f"{utt} {spk}\n" for utt, _, spk in rows)
    return os.path.join(root, "wav.scp"), os.path.join(root, "utt2lang")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("predict_label"))
    rows = _corpus(root, dur=1.5, seed=3)
    return root, rows, _label_files(root, rows)


@pytest.fixture(scope="module")
def port_exp(corpus):
    from speaker3d_tpu_torch.cli import train as t_train

    return _train(corpus, "port_exp", t_train.main, "--device", "cpu")


def _train(corpus, name, train_main, *extra):
    root = corpus[0]
    cfg, exp = _config(root, name, num_epoch=3, wav_len=1.0)
    train_main(["--config", cfg, *extra])
    return exp


def _jax_layout_copy(port_exp, dst):
    """The port's experiment with its checkpoint rewritten in the JAX
    trainer's layout, the weights converted by the JAX package."""
    from speaker3d_tpu.compat.torch_convert import convert_torch_state_dict
    from speaker3d_tpu.models.eres2netv2 import ERes2NetV2
    from speaker3d_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer

    states = Checkpointer(os.path.join(port_exp, "models")
                          ).recover_if_possible()
    tree = states["train_state"]
    os.makedirs(dst)
    for name in ("config.yaml", "label_encoder.pkl"):
        shutil.copy(os.path.join(port_exp, name), dst)
    jm = ERes2NetV2(feat_dim=80, embedding_size=32, m_channels=8,
                    num_blocks=(1, 1, 1, 1))
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          np.zeros((1, 50, 80), np.float32))
    variables = convert_torch_state_dict(tree["model"], like)
    JaxCheckpointer(os.path.join(dst, "models")).save_checkpoint(
        int(states["__meta__"]["epoch"]), {"train_state": {
            "params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map(
                np.asarray, variables["batch_stats"]),
            "cls_w": np.asarray(tree["cls_w"])}})
    return dst


@pytest.mark.parametrize("trainer", ["jax", "port"])
def test_predict_label_equals_jax(corpus, port_exp, trainer, tmp_path,
                                  capsys):
    from speaker3d_tpu.cli import train as j_train

    root, rows, (scp, utt2lang) = corpus
    if trainer == "jax":
        exp = jax_exp = _train(corpus, "jax_exp", j_train.main)
    else:
        exp = port_exp
        jax_exp = _jax_layout_copy(exp, str(tmp_path / "jax_layout"))
    outs = {}
    for tag, main, e in (("port", tcli.main, exp), ("jax", jcli.main,
                                                     jax_exp)):
        out = str(tmp_path / f"{tag}.txt")
        argv = ["--exp_dir", e, "--data", scp, "--utt2label", utt2lang,
                "--out", out]
        capsys.readouterr()
        main(argv + (["--device", "cpu"] if tag == "port" else []))
        printed = capsys.readouterr().out.splitlines()
        with open(out, "rb") as f:
            outs[tag] = (printed[-1], f.read())
    assert outs["port"] == outs["jax"]
    assert outs["port"][0].startswith("accuracy: ")
    assert len(outs["port"][1].splitlines()) == len(rows)


def test_predict_label_prints_predictions_without_labels(corpus, port_exp,
                                                         capsys):
    root, rows, (scp, _) = corpus
    capsys.readouterr()
    tcli.main(["--exp_dir", port_exp, "--data", scp, "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == len(rows)
    assert all(line.split()[1] in ("spk0", "spk1", "spk2")
               for line in printed)
