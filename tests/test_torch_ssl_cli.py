"""The port's SSL CLIs end to end with ``--device cpu`` at
``tests/test_ssl_cli_e2e.py``'s toy config (narrower: ECAPA channels 16 x
4, 48): ``train_ssl`` -> ``extract_ssl`` -> ``infer_sv_ssl``:

- the port trains RDINO for one epoch (``CKPT-EPOCH-1``), then resumes it
  for a second;
- the JAX package's ``extract_ssl`` on the port-written checkpoint gives
  the port's embeddings within 1e-5 of their largest magnitude;
- ``infer_sv_ssl`` prints the cosine of its saved ``.npy`` files in the
  JAX CLI's format;
- ``epochs: 0`` writes the random-init state as ``CKPT-EPOCH-0``, which
  ``extract_ssl`` reads;
- without ``--device cpu`` the entry points raise here.

``test_torch_ssl_cli_jax.py`` holds the JAX trainer on the port's
experiment and the port on the JAX trainer's checkpoint.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch
import yaml

from speaker3d_tpu.cli import extract_ssl as jextract
from speaker3d_tpu.eval.scoring import load_embeddings
from speaker3d_tpu_torch.cli import extract_ssl, infer_sv_ssl, train_ssl
from speaker3d_tpu_torch.utils.fileio import write_wav
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000
CONFIG = {"max_frames": 100, "glb_num": 2, "local_num": 4, "batch_size": 4,
          "num_workers": 2, "epochs": 1, "warmup_epochs": 1, "lr": 0.01,
          "n_mels": 80, "embedding_dim": 32, "out_dim": 64, "add_dim": 48,
          "bottleneck_dim": 16, "channels": [16, 16, 16, 16, 48]}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _ckpts(exp):
    return sorted(os.listdir(os.path.join(exp, "models")))


def make_experiment(tmp_path_factory) -> dict:
    """A toy corpus and config, and the port's one-epoch RDINO experiment."""
    root = str(tmp_path_factory.mktemp("ssl_cli"))
    rng = np.random.default_rng(0)
    scp = os.path.join(root, "wav.scp")
    with open(scp, "w") as f:
        for i in range(8):
            p = os.path.join(root, f"u{i}.wav")
            write_wav(p, (rng.standard_normal(3 * FS) * 0.1).astype(
                np.float32), FS)
            f.write(f"u{i} {p}\n")
    exp_dir = os.path.join(root, "exp")
    cfg = os.path.join(root, "cfg.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"exp_dir": exp_dir, "data": scp, **CONFIG}, f)
    out = {"root": root, "scp": scp, "cfg": cfg, "exp": exp_dir}
    out["epoch1"] = _run(train_ssl.main, ["--config", cfg, "--variant",
                                          "rdino", "--device", "cpu"])
    out["ckpts1"] = _ckpts(exp_dir)
    return out


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    out = make_experiment(tmp_path_factory)
    out["emb1"] = extract_both(out, "e1")
    out["epoch2"] = _run(train_ssl.main, ["--config", out["cfg"],
                                          "--variant", "rdino", "--device",
                                          "cpu", "--epochs=2"])
    return out


def extract_both(exp, tag):
    """(the port's, the JAX package's) extract_ssl embeddings of the
    experiment's latest checkpoint."""
    embs = []
    for name, main, extra in (("port", extract_ssl.main, ["--device", "cpu"]),
                              ("jax", jextract.main, [])):
        out_dir = os.path.join(exp["root"], f"emb_{tag}_{name}")
        _run(main, ["--exp_dir", exp["exp"], "--data", exp["scp"],
                    "--out_dir", out_dir, "--variant", "rdino"] + extra)
        assert os.listdir(out_dir) == ["embeddings_0.npz"]
        embs.append(load_embeddings(out_dir))
    return embs


def assert_same(got, want):
    assert sorted(got) == sorted(want) == [f"u{i}" for i in range(8)]
    for k in want:
        assert got[k].shape == want[k].shape == (32,)
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * np.abs(want[k]).max()


def test_one_epoch_writes_the_jax_trainers_logs_and_checkpoint(exp):
    assert exp["ckpts1"] == ["CKPT-EPOCH-1-00"]
    assert sorted(os.listdir(os.path.join(
        exp["exp"], "models", "CKPT-EPOCH-1-00"))) == ["CKPT.yaml",
                                                       "ssl_state.ckpt"]
    with open(os.path.join(exp["exp"], "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["epoch"] for line in lines] == [0, 1]
    assert sorted(lines[0]) == sorted(["epoch", "loss", "dino_loss",
                                       "reg_loss", "lr", "teacher_momentum",
                                       "time_s"])
    assert all(np.isfinite(line["loss"]) for line in lines)
    assert re.search(r"^epoch 1: \{'loss': ", exp["epoch1"], re.M)
    assert re.search(r"epoch 1: 2 steps of 4, step [\d.]+ ms", exp["epoch1"])


def test_resume_from_epoch_1(exp):
    assert "recovered from epoch 1" in exp["epoch2"]
    assert _ckpts(exp["exp"]) == ["CKPT-EPOCH-1-00", "CKPT-EPOCH-2-00"]


def test_jax_extract_ssl_reads_the_ports_checkpoint(exp):
    got, want = exp["emb1"]
    assert_same(got, want)


def test_infer_sv_ssl_prints_the_cosine_of_its_saved_embeddings(exp):
    wavs = [os.path.join(exp["root"], f"u{i}.wav") for i in (0, 1)]
    save = os.path.join(exp["root"], "sv_port")
    out = _run(infer_sv_ssl.main, ["--exp_dir", exp["exp"], "--variant",
                                   "rdino", "--wavs", *wavs, "--save_dir",
                                   save, "--device", "cpu"])
    a, b = (np.load(os.path.join(save, f"u{i}.npy")) for i in (0, 1))
    cos = float(np.dot(a.astype(np.float64), b) / (
        np.linalg.norm(a.astype(np.float64)) * np.linalg.norm(b)))
    got = float(re.search(r"\[INFO\] cosine similarity: ([-\d.]+)",
                          out).group(1))
    assert abs(got - cos) <= 1e-5


def test_epochs_0_writes_ckpt_epoch_0(exp):
    exp0 = os.path.join(exp["root"], "exp0")
    out = _run(train_ssl.main, ["--config", exp["cfg"], "--variant", "sdpn",
                                "--device", "cpu", f"--exp_dir={exp0}",
                                "--epochs=0"])
    assert "epoch" not in out
    assert _ckpts(exp0) == ["CKPT-EPOCH-0-00"]
    assert not os.path.exists(os.path.join(exp0, "log.txt"))
    out_dir = os.path.join(exp0, "emb")
    _run(extract_ssl.main, ["--exp_dir", exp0, "--data", exp["scp"],
                            "--out_dir", out_dir, "--variant", "sdpn",
                            "--device", "cpu"])
    embs = load_embeddings(out_dir)
    assert len(embs) == 8 and all(np.all(np.isfinite(e))
                                  for e in embs.values())


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(exp):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")  # pragma: no cover
    for main, argv in ((train_ssl.main, ["--config", exp["cfg"]]),
                       (extract_ssl.main, ["--exp_dir", exp["exp"], "--data",
                                           exp["scp"], "--out_dir", "x"]),
                       (infer_sv_ssl.main, ["--exp_dir", exp["exp"],
                                            "--wavs", "a.wav"])):
        with pytest.raises(RuntimeError, match="cpu"):
            main(argv)
