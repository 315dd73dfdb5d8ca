"""The port's VAD and segmenter trainers against the JAX package's on the
CPU: dataset items byte-equal and ``BatchLoader`` batches byte-equal for
two epochs; three train steps against ``make_vad_train_step`` /
``make_seg_train_step`` on a 1x1 mesh from the same weights and batches
(loss, acc and lr at rtol 1e-4, parameters and Adam moments at atol 1e-4);
the CLIs write and resume experiments in the JAX trainers' layout, which
the JAX loaders and trainers read, and resume JAX-written ones; and both
packages' diarization CLIs with a VAD, segmenter and x-vector trained by
the port's CLIs write identical RTTM and .vad_info.json bytes."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from tests import fsmn_experiments as fx
from tests.torch_threads import cap_torch_threads  # noqa: F401
from speaker3d_tpu.data import dataset as jdata
from speaker3d_tpu.data import dataset_seg as jds_seg
from speaker3d_tpu.data import dataset_vad as jds_vad
from speaker3d_tpu.models import fsmn_vad as jvad_model
from speaker3d_tpu.models import segmentation as jseg_model
from speaker3d_tpu.ops.fbank import FbankConfig as JFbankConfig
from speaker3d_tpu.ops.fbank import KaldiFbank as JKaldiFbank
from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu.train import seg_train as jseg_train
from speaker3d_tpu.train import vad_train as jvad_train
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.data import dataset as tdata
from speaker3d_tpu_torch.data import dataset_seg as tds_seg
from speaker3d_tpu_torch.data import dataset_vad as tds_vad
from speaker3d_tpu_torch.models import fsmn_vad as tvad_model
from speaker3d_tpu_torch.models import segmentation as tseg_model
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.train import seg_train as tseg_train
from speaker3d_tpu_torch.train import vad_train as tvad_train

FS = fx.FS


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tone corpus as a CSV, a path list and a wav.scp, a noise scp."""
    from speaker3d_tpu.utils.fileio import write_wav

    root = str(tmp_path_factory.mktemp("dnn_train"))
    csv = fx.write_corpus(root)
    with open(csv) as f:
        rows = [line.strip().split(",") for line in f][1:]
    lst, scp = os.path.join(root, "speech.list"), os.path.join(root, "wav.scp")
    with open(lst, "w") as f:
        f.write("\n".join(r[1] for r in rows) + "\n")
    with open(scp, "w") as f:
        f.write("".join(f"{r[0]} {r[1]}\n" for r in rows))
    u2s = os.path.join(root, "utt2spk")
    with open(u2s, "w") as f:
        f.write("".join(f"{r[0]} {r[2]}\n" for r in rows))
    noise = os.path.join(root, "noise.scp")
    rng = np.random.default_rng(9)
    with open(noise, "w") as f:
        for j in range(2):
            p = os.path.join(root, f"noise{j}.wav")
            write_wav(p, (0.05 * rng.standard_normal(FS * 3 // 2)).astype(
                np.float32), FS)
            f.write(f"n{j} {p}\n")
    return {"root": root, "csv": csv, "list": lst, "scp": scp,
            "utt2spk": u2s, "noise": noise}


def _datasets(corpus, kind, source, noise):
    kw = dict(noise=corpus["noise"] if noise else None, window_dur=1.5,
              seed=7, size=24)
    if kind == "vad":
        return (jds_vad.SyntheticVadDataset(corpus[source], **kw),
                tds_vad.SyntheticVadDataset(corpus[source], **kw))
    utt2spk = corpus["utt2spk"] if source == "scp" else None
    kw.update(utt2spk=utt2spk, max_speakers=2)
    return (jds_seg.SyntheticSegmentationDataset(corpus[source], **kw),
            tds_seg.SyntheticSegmentationDataset(corpus[source], **kw))


@pytest.mark.parametrize("kind,source,noise", [
    ("vad", "csv", False), ("vad", "list", True), ("vad", "scp", False),
    ("seg", "csv", True), ("seg", "scp", False)])
def test_dataset_items_byte_equal(corpus, kind, source, noise):
    jds, tds = _datasets(corpus, kind, source, noise)
    assert len(jds) == len(tds) == 24
    for i in range(len(jds)):
        (jw, jl), (tw, tl) = jds[i], tds[i]
        assert jw.dtype == tw.dtype and jw.tobytes() == tw.tobytes(), i
        assert jl.dtype == tl.dtype and jl.tobytes() == tl.tobytes(), i
    assert np.array_equal(tds_vad.frame_labels([(1600, 4800)], 8000),
                          jds_vad.frame_labels([(1600, 4800)], 8000))


@pytest.mark.parametrize("kind", ["vad", "seg"])
def test_loader_batches_byte_equal(corpus, kind):
    jds, tds = _datasets(corpus, kind, "csv", True)
    jl = jdata.BatchLoader(jds, batch_size=5, num_workers=2, seed=3)
    tl = tdata.BatchLoader(tds, batch_size=5, num_workers=2, seed=3)
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                assert g[k].tobytes() == w[k].tobytes(), (epoch, k)


SMALL = dict(feat_dim=80, hidden_dim=32, proj_dim=16, num_layers=2,
             lorder=10)


def _jax_and_port(kind, corpus):
    """The two packages' steps from one Flax init, and three batches."""
    if kind == "vad":
        jmodel = jvad_model.FSMNVad(**SMALL, rorder=3)
        tmodel = tvad_model.FSMNVad(**SMALL, rorder=3)
        jmake, tmake = jvad_train.make_vad_train_step, \
            tvad_train.make_vad_train_step
        jinit = jvad_train.init_vad_train_state
    else:
        jmodel = jseg_model.FSMNSegmenter(**SMALL, rorder=10, max_speakers=2)
        tmodel = tseg_model.FSMNSegmenter(**SMALL, rorder=10, max_speakers=2)
        jmake, tmake = jseg_train.make_seg_train_step, \
            tseg_train.make_seg_train_step
        jinit = jseg_train.init_seg_train_state
    _, tds = _datasets(corpus, kind, "csv", True)
    loader = tdata.BatchLoader(tds, batch_size=6, num_workers=1, seed=0)
    batches = list(loader)[:3]
    # step_per_epoch 2: the lr rises from min_lr toward max_lr in warm-up
    cfg = jvad_train.VadTrainConfig(min_lr=1e-4, max_lr=2e-3,
                                    step_per_epoch=2, fix_epoch=3)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jfb = JKaldiFbank(JFbankConfig(), mean_norm=False)
    feats = np.asarray(jfb(batches[0]["wavs"][:1]))
    jstate = jinit(jax.random.PRNGKey(4), jmodel, feats, mesh)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
    jstep = jmake(jmodel, cfg, mesh, host, feature_fn=jfb)
    tmodel.load_state_dict(state_dict_from_flax(
        {"params": host["params"]}, like=tmodel.state_dict()), strict=True)
    tstate = tvad_train.init_adam_train_state(tmodel, "cpu")
    tstep = tmake(tvad_train.VadTrainConfig(**cfg._asdict()),
                  feature_fn=KaldiFbank(FbankConfig(), mean_norm=False,
                                        device="cpu"))
    return jstep, jstate, tstep, tstate, batches


@pytest.mark.parametrize("kind", ["vad", "seg"])
def test_three_steps_match_the_jax_step(corpus, kind):
    jstep, jstate, tstep, tstate, batches = _jax_and_port(kind, corpus)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "acc", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"step {i} {key}")
    tree = tvad_train.state_tree(tstate)
    want = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
    assert int(tree["step"]) == int(want["step"]) == 3
    for key in ("params", "adam_m", "adam_v"):
        flat_t = jax.tree_util.tree_flatten_with_path(tree[key])[0]
        flat_j = jax.tree_util.tree_flatten_with_path(want[key])[0]
        assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
        for (path, a), (_, b) in zip(flat_t, flat_j):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=f"{key} {path}")
    # every parameter had a gradient
    assert all(float(np.abs(m).max()) > 0
               for m in jax.tree_util.tree_leaves(want["adam_m"]))


def _log_lines(exp):
    with open(os.path.join(exp, "train_epoch.log")) as f:
        return f.read().strip().splitlines()


def test_cli_write_resume_and_cross_read(corpus, tmp_path, capsys):
    """The port's CLIs write experiments that the JAX loaders and trainers
    read and resume; they resume JAX-written ones."""
    from speaker3d_tpu.cli import train_segmentation as jtrain_seg
    from speaker3d_tpu.cli import train_vad as jtrain_vad
    from speaker3d_tpu.diar import dnn_seg as jdnn_seg
    from speaker3d_tpu.diar import dnn_vad as jdnn_vad
    from speaker3d_tpu_torch.cli import train_segmentation as ttrain_seg
    from speaker3d_tpu_torch.cli import train_vad as ttrain_vad
    from speaker3d_tpu_torch.diar import dnn_seg as tdnn_seg
    from speaker3d_tpu_torch.diar import dnn_vad as tdnn_vad

    root, csv = str(tmp_path), corpus["csv"]
    wav = fx.conversation()
    for kind, (t_cli, j_cli, t_load, j_load, cfg_fn) in {
            "vad": (ttrain_vad, jtrain_vad, tdnn_vad.load_vad_exp,
                    jdnn_vad.load_vad_exp, fx.vad_config),
            "seg": (ttrain_seg, jtrain_seg,
                    tdnn_seg.load_segmentation_exp,
                    jdnn_seg.load_segmentation_exp, fx.seg_config)}.items():
        # the port writes epoch 1, then resumes to epoch 2 (2 steps each)
        cfg = cfg_fn(root, csv, f"port_{kind}", num_epoch=2, dataset_size=32)
        exp = fx.exp_dir(cfg)
        t_cli.main(["--config", cfg, "--device", "cpu", "--num_epoch=1"])
        t_cli.main(["--config", cfg, "--device", "cpu"])
        assert "recovered from epoch 1" in capsys.readouterr().out
        lines = _log_lines(exp)
        assert [line.split(" - ")[0] for line in lines] == ["epoch: 1",
                                                            "epoch: 2"]
        assert "data_wait_s" in lines[0] and "avg_acc" in lines[0]
        with open(os.path.join(exp, "config.yaml")) as f:
            assert yaml.safe_load(f)["model"] == yaml.safe_load(
                open(cfg))["model"]
        # the JAX loader reads it, and both give the same probabilities
        got, want = t_load(exp, device="cpu"), j_load(exp)
        if kind == "vad":
            assert got(wav)[0] == want(wav)[0]
        else:
            np.testing.assert_allclose(got(wav).data, want(wav).data,
                                       rtol=0, atol=1e-4)
        # the JAX trainer resumes the port's experiment at its epoch 3
        j_cli.main(["--config", os.path.join(exp, "config.yaml"),
                    "--num_epoch=3"])
        assert "recovered from epoch 2" in capsys.readouterr().out
        assert len(_log_lines(exp)) == 3
        # and the port resumes the JAX trainer's checkpoint
        t_cli.main(["--config", os.path.join(exp, "config.yaml"),
                    "--device", "cpu", "--num_epoch=4"])
        assert "recovered from epoch 3" in capsys.readouterr().out
        assert len(_log_lines(exp)) == 4


def test_trainers_refuse(tmp_path, monkeypatch):
    from speaker3d_tpu_torch.cli import train_segmentation, train_vad

    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"exp_dir: {tmp_path / 'exp'}\nspeech: x.csv\n")
    for cli in (train_vad, train_segmentation):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(["--config", str(cfg)])
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "0")
        with pytest.raises(NotImplementedError, match="M14"):
            cli.main(["--config", str(cfg), "--device", "cpu"])
        monkeypatch.delenv("WORLD_SIZE")
        monkeypatch.delenv("RANK")


def test_cli_dnn_front_identical_rttm_port_trained(corpus):
    """A VAD and a segmenter trained by the port's CLIs (which the JAX CLI
    reads) and the JAX-trained x-vector through both packages'
    diarization CLIs."""
    from speaker3d_tpu.cli import train as jtrain
    from speaker3d_tpu.utils.fileio import write_wav
    from speaker3d_tpu_torch.cli import train_segmentation as ttrain_seg
    from speaker3d_tpu_torch.cli import train_vad as ttrain_vad

    root, csv = os.path.join(corpus["root"], "cli"), corpus["csv"]
    os.makedirs(root)
    exps = []
    for cli, cfg_fn in ((ttrain_vad, fx.vad_config),
                        (ttrain_seg, fx.seg_config)):
        cfg = cfg_fn(root, csv)
        cli.main(["--config", cfg, "--device", "cpu"])
        exps.append(fx.exp_dir(cfg))
    sv_cfg = fx.sv_config(root, csv)
    jtrain.main(["--config", sv_cfg])
    vad_dir, seg_dir, sv_dir = exps + [fx.exp_dir(sv_cfg)]
    wav = os.path.join(root, "conv.wav")
    write_wav(wav, fx.conversation(), FS)
    fx.check_identical_rttm(fx.diarize_both(root, "port_exps", wav, sv_dir,
                                            vad_dir, seg_dir))
