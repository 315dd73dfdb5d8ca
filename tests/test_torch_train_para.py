"""The port's ASR-encoder-fused trainer (``cli/train_para.py``) against the
JAX package's.

- The host LFR, CMVN and ``load_cmvn`` are bit-equal to the JAX functions
  (float32 numpy both), LFR over a hypothesis sweep of T, ``lfr_m`` and
  ``lfr_n``.
- The frozen frontend (Hamming fbank, LFR, CMVN, a 2-layer SAN-M at
  d_model 32 from one pickled ``encoder_ckpt``) matches the JAX
  ``build_frozen_frontend`` at ``FRONT_TOL`` of the output's scale: the two
  fbanks differ by rounding (~2e-5 in log-mel), which the encoder carries.
- ``load_funasr_encoder`` on the funasr torch mirror's state_dict
  (``tests/test_train_para.py::_torch_funasr_sanm``) gives the mirror's
  output (bit for bit in the weights; the outputs within 1e-5 with the
  mirror's LayerNorms at the port's eps 1e-6, and within the JAX test's
  2e-4 at funasr's 1e-5), the same weights as the JAX converter, and a
  shape mismatch raises naming the key.
- Three fused steps (the frozen frontend as ``feature_fn`` of the SV step,
  x-vector on top) match the JAX step from one start at
  ``tests/test_torch_sv_train.py``'s tolerances.
- The encoder is in neither the momentum nor the checkpoint, and each
  package's CLI resumes the other's tiny experiment
  (``tests/test_train_para.py::test_train_para_e2e``'s corpus, 2 epochs,
  the same ``encoder_ckpt``).
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from speaker3d_tpu.cli import train_para as jtp
from speaker3d_tpu.compat.funasr_convert import (
    load_funasr_encoder as jax_load_funasr_encoder)
from speaker3d_tpu.data import processor_para as jpp
from speaker3d_tpu.models.sanm import SANMEncoder as JaxSANMEncoder
from speaker3d_tpu.models.xvector import Xvector as JaxXvector
from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu.train import sv_train as jsv
from speaker3d_tpu_torch.cli import train_para as ttp
from speaker3d_tpu_torch.compat.flax_convert import (
    flax_from_state_dict, state_dict_from_flax)
from speaker3d_tpu_torch.compat.funasr_convert import load_funasr_encoder
from speaker3d_tpu_torch.data import processor_para as tpp
from speaker3d_tpu_torch.models.fsmn_vad import lecun_init_
from speaker3d_tpu_torch.models.sanm import FLAX_JOINED_NAMES, SANMEncoder
from speaker3d_tpu_torch.models.xvector import Xvector
from speaker3d_tpu_torch.train import sv_train as tsv
from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
from tests.test_train_para import _torch_funasr_sanm
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000
ENCODER = {"d_model": 32, "num_heads": 2, "ffn_dim": 64, "num_layers": 2,
           "kernel_size": 5}
XVECTOR = {"hid_dim": 16, "stats_dim": 32, "embed_dim": 16}
FRONT_TOL = 1e-4
TOL = 1e-4                         # tests/test_torch_sv_train.py's
NUM_CLASSES = 4
# the SV parity test's schedule: steps 20-22 inside the warm-up and the
# margin ramp, a small lr (that file explains why)
SCHED = dict(num_classes=NUM_CLASSES, embedding_size=16, step_per_epoch=10,
             warmup_epoch=5, fix_epoch=12, increase_start_epoch=1,
             margin_fix_epoch=8, final_margin=0.3, max_lr=0.001)
START = 20


def _write_cmvn(path, dim, rng):
    means = -rng.uniform(5, 10, dim)
    scales = rng.uniform(0.1, 0.3, dim)
    with open(path, "w") as f:
        f.write(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n")
        for tag, v in (("AddShift", means), ("Rescale", scales)):
            f.write(f"<{tag}> {dim} {dim}\n<LearnRateCoef> 0 [ "
                    + " ".join(f"{x:.6f}" for x in v) + " ]\n")
        f.write("</Nnet>\n")


def _corpus(root):
    """tests/test_train_para.py::test_train_para_e2e's corpus: 2 speakers x
    4 one-second tones."""
    from speaker3d_tpu_torch.utils.fileio import write_wav

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    with open(os.path.join(root, "train.csv"), "w") as f:
        f.write("ID,wav,spk\n")
        for s in range(2):
            for u in range(4):
                wav = (0.3 * np.sin(2 * np.pi * (250 + 900 * s)
                                    * np.arange(FS) / FS)
                       + 0.01 * rng.standard_normal(FS)).astype(np.float32)
                p = os.path.join(root, "wav", f"s{s}u{u}.wav")
                write_wav(p, wav, FS)
                f.write(f"s{s}u{u},{p},spk{s}\n")
    return os.path.join(root, "train.csv")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, a pickled Flax encoder tree (the port's seeded init) and
    a CMVN file; the config of both CLIs."""
    root = str(tmp_path_factory.mktemp("para"))
    csv = _corpus(root)
    enc = SANMEncoder(input_dim=560, **ENCODER)
    lecun_init_(enc, torch.Generator().manual_seed(3))
    with torch.no_grad():  # LayerNorms off their init, so they are compared
        for name, p in enc.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                         .manual_seed(len(name))))
    params = flax_from_state_dict(enc.state_dict(),
                                  joined=FLAX_JOINED_NAMES)["params"]
    ckpt = os.path.join(root, "encoder.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump(params, f)
    cmvn = os.path.join(root, "am.mvn")
    _write_cmvn(cmvn, 560, np.random.default_rng(4))
    config = {
        "data": csv, "wav_len": 1.0, "speed_pertub": False, "aug_prob": 0.0,
        "batch_size": 4, "num_workers": 2, "num_epoch": 2,
        "embedding_size": 16, "max_lr": 0.05, "min_lr": 0.005,
        "warmup_epoch": 1, "log_batch_freq": 1, "lfr_m": 7, "lfr_n": 6,
        "fbank_dim": 80, "encoder_ckpt": ckpt,
        "asr_encoder": {"args": dict(ENCODER)},
        "model": {"obj": "speaker3d_tpu.models.xvector.Xvector",
                  "args": dict(XVECTOR)}}
    return root, config, cmvn, enc


def _wavs(b=4, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(FS) / FS
    f0 = rng.uniform(150, 900, (b, 1))
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal((b, FS))).astype(np.float32)


@settings(max_examples=40, deadline=None)
@given(t=st.integers(1, 60), lfr_m=st.integers(1, 9),
       lfr_n=st.integers(1, 8), seed=st.integers(0, 2**16))
def test_host_lfr_is_bit_equal(t, lfr_m, lfr_n, seed):
    x = np.random.default_rng(seed).standard_normal((t, 5)).astype(np.float32)
    got, want = tpp.apply_lfr(x, lfr_m, lfr_n), jpp.apply_lfr(x, lfr_m, lfr_n)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    dev = tpp.apply_lfr_device(torch.from_numpy(x)[None], lfr_m, lfr_n)
    np.testing.assert_array_equal(dev[0].numpy(), want)


def test_host_cmvn_and_load_cmvn_are_bit_equal(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "am.mvn")
    _write_cmvn(path, 40, rng)
    got, want = tpp.load_cmvn(path), jpp.load_cmvn(path)
    assert got.shape == (2, 40) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    x = rng.standard_normal((17, 24)).astype(np.float32)
    np.testing.assert_array_equal(tpp.apply_cmvn(x, got),
                                  jpp.apply_cmvn(x, want))


@pytest.fixture(scope="module")
def jax_front(setup):
    """The JAX frontends from the same encoder_ckpt, without and with the
    CMVN."""
    _, config, cmvn, _ = setup
    out = {}
    for name, extra in (("plain", {}), ("cmvn", {"cmvn_file": cmvn})):
        fn, d_model, wav_len = jtp.build_frozen_frontend(
            dict(config, **extra), 1234)
        out[name] = (jax.jit(fn), d_model, wav_len)
    return out


@pytest.mark.parametrize("front", ["plain", "cmvn"])
def test_frozen_frontend_matches_jax(setup, jax_front, front):
    _, config, cmvn, _ = setup
    extra = {"cmvn_file": cmvn} if front == "cmvn" else {}
    frontend, d_model, wav_len = ttp.build_frozen_frontend(
        dict(config, **extra), 1234, "cpu")
    jfn, jd, jlen = jax_front[front]
    assert (d_model, wav_len) == (jd, jlen) == (32, FS)
    assert frontend.fbank.cfg.window_type == "hamming"
    assert not any(p.requires_grad for p in frontend.encoder.parameters())
    wavs = _wavs(seed=2)
    want = np.asarray(jfn(wavs))
    got = frontend(torch.from_numpy(wavs))
    assert not got.requires_grad and got.shape == want.shape == (4, 17, 32)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= FRONT_TOL, err


def test_seeded_encoder_is_flax_init_from_seed_plus_7(setup):
    _, config, _, _ = setup
    cfg = dict(config, encoder_ckpt=None)
    a, _, _ = ttp.build_frozen_frontend(cfg, 11, "cpu")
    b = SANMEncoder(input_dim=560, **ENCODER)
    lecun_init_(b, torch.Generator().manual_seed(18))
    for (k, v), w in zip(a.encoder.state_dict().items(),
                         b.state_dict().values()):
        assert torch.equal(v, w), k


def test_load_funasr_encoder_matches_the_mirror_and_the_jax_converter():
    dims = dict(input_dim=20, d_model=16, num_heads=2, ffn_dim=32,
                num_layers=3, kernel_size=5)
    torch.manual_seed(0)
    oracle = _torch_funasr_sanm(**dims).eval()
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    x = np.random.default_rng(2).standard_normal((2, 23, 20)).astype(
        np.float32)
    sd = {f"encoder.{k}": v for k, v in oracle.state_dict().items()}
    sd["decoder.something.weight"] = torch.zeros(1)
    enc = load_funasr_encoder(sd, SANMEncoder(**dims)).eval()
    for k, v in oracle.state_dict().items():
        assert torch.equal(enc.state_dict()[k], v), k
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
        want_1e5 = oracle(torch.from_numpy(x)).numpy()
        for m in oracle.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.eps = 1e-6
        want = oracle(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_1e5, rtol=0, atol=2e-4)

    params = jax_load_funasr_encoder(sd, JaxSANMEncoder(**dims), x[:1])
    jsd = state_dict_from_flax({"params": jax.tree_util.tree_map(
        np.asarray, params)}, like=enc.state_dict())
    assert sorted(jsd) == sorted(enc.state_dict())
    for k, v in jsd.items():
        assert torch.equal(v, enc.state_dict()[k]), k

    bad = dict(sd)
    bad["encoder.encoders.0.self_attn.fsmn_block.weight"] = torch.zeros(
        16, 1, 7)
    with pytest.raises(ValueError, match="encoders.0.self_attn.fsmn_block"):
        load_funasr_encoder(bad, SANMEncoder(**dims))


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Three JAX SV steps with the JAX frozen frontend from one start."""
    _, config, _, _ = setup
    fn, d_model, wav_len = jtp.build_frozen_frontend(config, 1234)
    jmodel = JaxXvector(feat_dim=d_model, **XVECTOR)
    example = np.asarray(fn(np.zeros((1, wav_len), np.float32)))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        jmodel.init, static_argnames=("train",))(
            jax.random.PRNGKey(0), example, train=True))
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    cfg = jsv.SVTrainConfig(**SCHED)
    state = jsv.init_sv_train_state(jax.random.PRNGKey(0), jmodel, example,
                                    cfg, mesh, backbone_variables=variables)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(state))
    host["step"] = np.asarray(START, np.int32)
    step = jsv.make_sv_train_step(jmodel, cfg, mesh, host, feature_fn=fn)
    state = jax.device_put(host, jsv.state_shardings(host, mesh))
    rng = np.random.default_rng(5)
    batches = [{"wavs": _wavs(seed=10 + i),
                "labels": rng.integers(0, NUM_CLASSES, 4).astype(np.int32)}
               for i in range(3)]
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return host, batches, metrics, jax.tree_util.tree_map(
        np.asarray, jax.device_get(state))


def test_fused_steps_match_the_jax_step(setup, jax_steps):
    _, config, _, _ = setup
    host, batches, want_metrics, want = jax_steps
    frontend, d_model, _ = ttp.build_frozen_frontend(config, 1234, "cpu")
    model = Xvector(feat_dim=d_model, **XVECTOR)
    model.load_state_dict(state_dict_from_flax(
        {"params": host["params"], "batch_stats": host["batch_stats"]},
        like=model.state_dict()), strict=True)
    cfg = tsv.SVTrainConfig(**SCHED)
    state = tsv.init_sv_train_state(model, cfg, device="cpu",
                                    cls_w=host["cls_w"])
    state.step = START
    step = tsv.make_sv_train_step(model, cfg, feature_fn=frontend)
    enc_before = {k: v.clone() for k, v in frontend.encoder.state_dict()
                  .items()}
    for batch, wm in zip(batches, want_metrics):
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "acc", "lr", "margin"):
            np.testing.assert_allclose(float(m[k]), wm[k], rtol=TOL,
                                       err_msg=k)
    got = tsv.flax_state_tree(state)
    flat = dict(_flatten(got))
    for key, v in _flatten(want):
        if key[0] == "momentum":
            scale = max(np.abs(v).max(), 1e-12)
            np.testing.assert_allclose(flat[key] / scale, v / scale,
                                       rtol=0, atol=TOL, err_msg=str(key))
        else:
            np.testing.assert_allclose(flat[key], v, rtol=0, atol=TOL,
                                       err_msg=str(key))
    assert sorted(flat) == sorted(k for k, _ in _flatten(want))
    # frozen: the encoder moved by no bit and is not in the train state
    for k, v in frontend.encoder.state_dict().items():
        assert torch.equal(v, enc_before[k]), k
    assert set(state.momentum["model"]) == {
        n for n, _ in model.named_parameters()}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _write_config(root, name, config):
    cfg = dict(config, exp_dir=os.path.join(root, name))
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg["exp_dir"]


@pytest.fixture(scope="module")
def experiments(setup):
    """2 epochs of each package's CLI on the e2e corpus."""
    root, config, _, _ = setup
    out = {}
    for pkg, main, extra in (("jax", jtp.main, []),
                             ("port", ttp.main, ["--device", "cpu"])):
        path, exp = _write_config(root, f"exp_{pkg}", config)
        main(["--config", path] + extra)
        out[pkg] = (path, exp)
    return out


def test_checkpoint_holds_no_encoder(experiments):
    path, exp = experiments["port"]
    tree = Checkpointer(os.path.join(exp, "models")).recover_if_possible()[
        "train_state"]
    keys = [k for k, _ in _flatten(tree)]
    assert sorted(tree) == ["batch_stats", "cls_w", "momentum", "params",
                            "step"]
    assert not any("encoders" in "/".join(k) or "after_norm" in "/".join(k)
                   for k in keys)
    assert {k[1:] for k in keys if k[0] == "params"} == {
        k[2:] for k in keys if k[:2] == ("momentum", "params")}
    jtree = Checkpointer(os.path.join(experiments["jax"][1], "models")
                         ).recover_if_possible()["train_state"]
    assert sorted(keys) == sorted(k for k, _ in _flatten(jtree))


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_each_cli_resumes_the_others_experiment(experiments, resumer,
                                                capsys):
    other = "jax" if resumer == "port" else "port"
    path, exp = experiments[other]
    if resumer == "port":
        ttp.main(["--config", path, "--device", "cpu", "--num_epoch=3"])
    else:
        jtp.main(["--config", path, "--num_epoch=3"])
    out = capsys.readouterr().out
    assert "recovered from epoch 2" in out, out
    assert "epoch 3 step 2/2" in out, out
    lines = open(os.path.join(exp, "train_epoch.log")).read().splitlines()
    assert len(lines) == 3 and lines[-1].startswith("epoch: 3"), lines
    loss = float(lines[-1].split("avg_loss:")[1].split(" - ")[0])
    assert np.isfinite(loss)
    assert os.path.isdir(os.path.join(exp, "models", "CKPT-EPOCH-3-00"))


def test_model_parallel_is_refused(setup):
    """In one process: two class shards need two ranks (torchrun runs it,
    ``tests/test_torch_sv_train_sharded.py`` holds the mesh step)."""
    root, config, _, _ = setup
    path, _ = _write_config(root, "exp_mp", dict(config, model_parallel=2))
    with pytest.raises(ValueError, match="has 1 devices, needs 2"):
        ttp.main(["--config", path, "--device", "cpu"])
