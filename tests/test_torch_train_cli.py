"""The port's trainer CLI and ``--exp_dir`` in its inference CLIs, on the
CPU, against the JAX package's.

- ``cli.train`` writes the JAX trainer's experiment layout (``config.yaml``,
  ``models/CKPT-EPOCH-N-00``, ``train_epoch.log``, ``label_encoder.pkl``)
  and resumes from it.
- An experiment trained by the JAX ``cli.train`` loads in the port's
  ``extract --exp_dir``: embeddings at rtol = atol = 3e-4 against the JAX
  ``extract --exp_dir``.
- Warm-started (``init_exp_dir``) from that experiment, one epoch of the
  port's trainer gives the JAX trainer's ``avg_loss`` at rtol 1e-4.
- ``infer_sv_batch``, ``serve_embedding``, ``check_single_speaker`` and
  ``infer_diarization`` take ``--exp_dir``.

Both trainers see one device holding the whole batch: the batch of 5 has
no common factor with the JAX test harness's 8 virtual devices, so the JAX
CLI's mesh is 1 x 1.
"""

import json
import os
import pickle

import numpy as np
import pytest
import yaml

from speaker3d_tpu_torch.cli import (
    check_single_speaker as t_check, extract as t_extract,
    infer_diarization as t_diar, infer_sv_batch as t_batch,
    serve_embedding as t_serve, train as t_train)
from speaker3d_tpu_torch.utils.fileio import write_wav
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000


def _corpus(root, n_spk=3, n_utt=6, dur=1.0, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    rows = []
    for s in range(n_spk):
        for u in range(n_utt):
            t = np.arange(int(dur * FS)) / FS
            f = (200, 800, 2600)[s] * (1 + 0.02 * rng.standard_normal())
            wav = (0.3 * np.sin(2 * np.pi * f * t)
                   + 0.1 * np.sin(2 * np.pi * 2 * f * t)
                   + 0.05 * rng.standard_normal(len(t)))
            path = os.path.join(root, "wav", f"spk{s}_utt{u}.wav")
            write_wav(path, wav.astype(np.float32), FS)
            rows.append((f"spk{s}_utt{u}", path, f"spk{s}"))
    with open(os.path.join(root, "train.csv"), "w") as f:
        f.write("ID,wav,spk\n")
        f.writelines(f"{a},{b},{c}\n" for a, b, c in rows)
    with open(os.path.join(root, "wav.scp"), "w") as f:
        f.writelines(f"{a} {b}\n" for a, b, _ in rows)
    return rows


def _config(root, name, **extra):
    config = {
        "exp_dir": os.path.join(root, name),
        "data": os.path.join(root, "train.csv"),
        "sample_rate": FS, "n_mels": 80, "wav_len": 0.6,
        "speed_pertub": True, "aug_prob": 0.0,
        "batch_size": 5, "num_workers": 1, "num_epoch": 1,
        "model_parallel": 1, "embedding_size": 32,
        "max_lr": 0.05, "min_lr": 0.001, "warmup_epoch": 1,
        "log_batch_freq": 100,
        "model": {"obj": "speaker3d_tpu.models.eres2netv2.ERes2NetV2",
                  "args": {"feat_dim": 80, "embedding_size": 32,
                           "m_channels": 8, "num_blocks": [1, 1, 1, 1]}},
        **extra,
    }
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config["exp_dir"]


def _log(exp_dir):
    with open(os.path.join(exp_dir, "train_epoch.log")) as f:
        return [dict(kv.split(": ") for kv in line.strip().split(" - "))
                for line in f]


@pytest.fixture(scope="module")
def jax_exp(tmp_path_factory):
    """One epoch of the JAX trainer on the tiny corpus."""
    from speaker3d_tpu.cli import train as j_train

    root = str(tmp_path_factory.mktemp("jax_exp"))
    rows = _corpus(root)
    cfg, exp = _config(root, "jax")
    j_train.main(["--config", cfg])
    return root, rows, exp


def test_train_writes_the_experiment_and_resumes(tmp_path, capsys):
    root = str(tmp_path)
    _corpus(root)
    cfg, exp = _config(root, "exp", num_epoch=2)
    t_train.main(["--config", cfg, "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(exp, "models"))) == [
        "CKPT-EPOCH-1-00", "CKPT-EPOCH-2-00"]
    ck = os.path.join(exp, "models", "CKPT-EPOCH-2-00")
    assert sorted(os.listdir(ck)) == ["CKPT.yaml", "epoch_counter.ckpt",
                                      "train_state.ckpt"]
    with open(os.path.join(exp, "config.yaml")) as f:
        assert yaml.safe_load(f)["num_epoch"] == 2
    with open(os.path.join(exp, "label_encoder.pkl"), "rb") as f:
        assert pickle.load(f) == {"spk0": 0, "spk1": 1, "spk2": 2}
    log = _log(exp)
    assert [r["epoch"] for r in log] == ["1", "2"]
    assert list(log[0]) == ["epoch", "time_s", "data_wait_s", "avg_loss",
                            "avg_acc"]
    assert all(np.isfinite(float(r["avg_loss"])) for r in log)
    with np.load(os.path.join(ck, "train_state.ckpt")) as z:
        assert int(z["step"]) == 2 * 3  # 18 utterances, batch 5: 3 steps
        assert z["cls_w"].shape == (9, 32)  # 3 speakers x 3 speeds
        assert "model/layer1.0.bn1.running_mean" in z.files
        assert "momentum/model/layer1.0.conv1.weight" in z.files
        assert "momentum/model/layer1.0.bn1.running_mean" not in z.files
    out = capsys.readouterr().out
    assert "epoch 2: 3 steps of 5, step " in out and "(median; the first" in out
    # resume: a third epoch only, the step counter continued
    t_train.main(["--config", cfg, "--device", "cpu", "--num_epoch=3"])
    assert "recovered from epoch 2" in capsys.readouterr().out
    assert [r["epoch"] for r in _log(exp)] == ["1", "2", "3"]
    with np.load(os.path.join(exp, "models", "CKPT-EPOCH-3-00",
                              "train_state.ckpt")) as z:
        assert int(z["step"]) == 3 * 3


def test_jax_experiment_loads_in_the_port_extract(jax_exp, tmp_path):
    from speaker3d_tpu.cli import extract as j_extract
    from speaker3d_tpu.eval.scoring import load_embeddings

    root, rows, exp = jax_exp
    scp = os.path.join(root, "wav.scp")
    for mode in ("chunked", "exact"):
        j_dir, t_dir = tmp_path / f"jax_{mode}", tmp_path / f"torch_{mode}"
        j_extract.main(["--exp_dir", exp, "--data", scp, "--out_dir",
                        str(j_dir), "--mode", mode, "--batch_size", "8"])
        t_extract.main(["--exp_dir", exp, "--data", scp, "--out_dir",
                        str(t_dir), "--mode", mode, "--batch_size", "8",
                        "--device", "cpu"])
        want, got = load_embeddings(str(j_dir)), load_embeddings(str(t_dir))
        assert sorted(got) == sorted(want) and len(got) == len(rows)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=3e-4, atol=3e-4)
    model, config = t_extract.build_model_from_exp(exp)
    assert not model.training and config["embedding_size"] == 32


def test_warm_start_from_the_jax_experiment_equals_the_jax_trainer(jax_exp):
    from speaker3d_tpu.cli import train as j_train

    root, _, src = jax_exp
    j_cfg, j_exp = _config(root, "jax_ft", init_exp_dir=src)
    t_cfg, t_exp = _config(root, "torch_ft", init_exp_dir=src)
    j_train.main(["--config", j_cfg])
    t_train.main(["--config", t_cfg, "--device", "cpu"])
    (want,), (got,) = _log(j_exp), _log(t_exp)
    assert float(got["avg_loss"]) == pytest.approx(float(want["avg_loss"]),
                                                   rel=1e-4)
    assert float(got["avg_acc"]) == pytest.approx(float(want["avg_acc"]),
                                                  abs=1e-6)


@pytest.fixture(scope="module")
def port_exp(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_exp"))
    rows = _corpus(root, dur=3.0)
    cfg, exp = _config(root, "exp")
    t_train.main(["--config", cfg, "--device", "cpu"])
    return root, rows, exp


def test_inference_clis_take_the_experiment(port_exp, tmp_path, monkeypatch):
    from speaker3d_tpu_torch import serve as t_serve_mod

    root, rows, exp = port_exp
    model, _ = t_extract.build_model_from_exp(exp)
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn

    embed = build_embedding_fn(model, device="cpu", precision="high")
    wav_list = tmp_path / "wavs.txt"
    wav_list.write_text("".join(p + "\n" for _, p, _ in rows[:3]))
    t_batch.main(["--exp_dir", exp, "--wavs", str(wav_list), "--out_dir",
                  str(tmp_path / "batch"), "--device", "cpu"])
    got = np.load(tmp_path / "batch" / f"{rows[0][0]}.npy")
    assert got.shape == (32,) and np.isfinite(got).all()

    served = {}
    monkeypatch.setattr(t_serve_mod, "serve",
                        lambda fn, **kw: served.update(fn=fn, **kw))
    t_serve.main(["--exp_dir", exp, "--device", "cpu", "--port", "0"])
    wav = np.zeros((2, 16000), np.float32)
    np.testing.assert_allclose(served["fn"](wav).numpy(), embed(wav).numpy(),
                               rtol=1e-6, atol=1e-6)

    # a two-speaker file: speaker 0's and speaker 2's utterances in turn
    from speaker3d_tpu_torch.utils.fileio import read_wav

    parts = [read_wav(p)[0][0] for _, p, _ in (rows[0], rows[12], rows[1],
                                               rows[13])]
    conv = str(tmp_path / "conv.wav")
    write_wav(conv, np.concatenate(parts), FS)
    out = tmp_path / "single.json"
    t_check.main(["--wav", conv, "--exp_dir", exp, "--out", str(out),
                  "--device", "cpu"])
    with open(out) as f:
        assert {"is_single_speaker", "min_pairwise_cosine"} <= set(json.load(f))
    t_diar.main(["--wav", conv, "--out_dir", str(tmp_path / "diar"),
                 "--exp_dir", exp, "--device", "cpu"])
    with open(tmp_path / "diar" / "conv.rttm") as f:
        lines = f.read().splitlines()
    assert lines and all(line.startswith("SPEAKER conv ") for line in lines)
