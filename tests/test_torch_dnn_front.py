"""The port's DNN front end of diarization (``diar/dnn_vad.py``,
``diar/dnn_seg.py``) against the JAX package's wrappers on the CPU, on one
VAD and one segmenter experiment trained by the JAX CLIs at the JAX tests'
tiny size (tests/fsmn_experiments.py): probabilities against the JAX
wrappers' jitted ``_forward`` on the same windows at atol 1e-4, the VAD's
flags equal with no probability within 1e-4 of its threshold, the
segmenter's activations equal once binarized at 0.5; the chunk grid; short
and empty input; the loaders' refusals; and both packages' diarization
CLIs with these experiments (``--vad_exp_dir``, ``--include_overlap``,
``--segmentation_exp_dir`` and the tiny x-vector ``--exp_dir`` of
tests/test_segmentation.py) writing identical RTTM and .vad_info.json
bytes on an overlapping mixture."""

import os

import numpy as np
import pytest
import torch

from tests import fsmn_experiments as fx
from speaker3d_tpu.diar import dnn_seg as jseg
from speaker3d_tpu.diar import dnn_vad as jvad
from speaker3d_tpu_torch.diar import dnn_seg as tseg
from speaker3d_tpu_torch.diar import dnn_vad as tvad
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = fx.FS
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_exps(tmp_path_factory):
    from speaker3d_tpu.cli.train_segmentation import main as train_seg
    from speaker3d_tpu.cli.train_vad import main as train_vad

    root = str(tmp_path_factory.mktemp("dnn_front"))
    csv = fx.write_corpus(root)
    vad_cfg, seg_cfg = fx.vad_config(root, csv), fx.seg_config(root, csv)
    train_vad(["--config", vad_cfg])
    train_seg(["--config", seg_cfg])
    return fx.exp_dir(vad_cfg), fx.exp_dir(seg_cfg), root, csv


def _test_wav(seed=1):
    rng = np.random.default_rng(seed)
    sil = (0.002 * rng.standard_normal(FS)).astype(np.float32)
    return np.concatenate([sil, fx.speech_like(rng, 2 * FS, 250.0), sil,
                           fx.speech_like(rng, 3 * FS, 420.0),
                           0.5 * sil[:FS // 3]])


def _clear_of(probs, threshold, what):
    """No probability within ATOL of the threshold: flags are then equal
    whenever the probabilities agree to ATOL."""
    near = np.argwhere(np.abs(probs - threshold) <= ATOL)
    if near.size:
        idx = tuple(near[0])
        pytest.fail(f"{what}: probability {probs[idx]!r} at {idx} lies within "
                    f"{ATOL} of the threshold {threshold}")


def _jax_vad_windows(vad, wav):
    """The JAX DnnVAD's own windowing (speaker3d_tpu/diar/dnn_vad.py)."""
    x = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    n = x.shape[0]
    t = 1 + (n - vad.frame_length) // vad.frame_shift
    n_chunks = -(-t // vad.chunk)
    windows = np.zeros((n_chunks, vad.win_samples), np.float32)
    for k in range(n_chunks):
        s0 = (k * vad.chunk - vad.ctx) * vad.frame_shift
        lo, hi = max(s0, 0), min(s0 + vad.win_samples, n)
        windows[k, lo - s0:hi - s0] = x[lo:hi]
    return windows, t


def test_dnn_vad_equals_jax(jax_exps):
    vad_dir = jax_exps[0]
    jv = jvad.load_vad_exp(vad_dir)
    tv = tvad.load_vad_exp(vad_dir, device="cpu")
    assert (tv.win_samples, tv.chunk, tv.ctx, tv.frame_ms) == (
        jv.win_samples, jv.chunk, jv.ctx, jv.frame_ms)
    wav = _test_wav()
    windows, t = _jax_vad_windows(jv, wav)
    want, b = [], jv.batch
    for i in range(0, len(windows), b):
        batch = np.zeros((b, jv.win_samples), np.float32)
        got = min(b, len(windows) - i)
        batch[:got] = windows[i:i + got]
        want.append(np.asarray(jv._forward(batch))[:got])
        # the port's forward on the same batch
        np.testing.assert_allclose(tv.forward(torch.from_numpy(batch)).numpy(),
                                   np.asarray(jv._forward(batch)), rtol=0,
                                   atol=ATOL)
    want = np.concatenate(want)[:, jv.ctx:jv.ctx + jv.chunk].reshape(-1)[:t]
    probs, x = tv.frame_probs(wav)
    np.testing.assert_allclose(probs, want, rtol=0, atol=ATOL)
    _clear_of(want, jv.threshold, "JAX DnnVAD frame probabilities")
    flags, x_t = tv(wav)
    flags_j, x_j = jv(wav)
    assert flags == flags_j
    assert np.array_equal(x_t, x_j) and np.array_equal(x, x_j)
    # the VAD found the tones
    assert 0.5 < np.mean(flags) < 0.9


def test_dnn_segmenter_equals_jax(jax_exps):
    seg_dir = jax_exps[1]
    js = jseg.load_segmentation_exp(seg_dir)
    ts = tseg.load_segmentation_exp(seg_dir, device="cpu")
    for wav in (fx.conversation(), _test_wav(2)):
        want, got = js(wav, FS), ts(wav, FS)
        assert got.data.shape == want.data.shape
        assert np.array_equal(got.chunk_starts, want.chunk_starts)
        assert got.chunk_starts.dtype == want.chunk_starts.dtype
        assert (got.frame_step, got.frame_duration) == (
            want.frame_step, want.frame_duration)
        np.testing.assert_allclose(got.data, want.data, rtol=0, atol=ATOL)
        # the segmenter has no threshold of its own (the pipeline's
        # --segmentation_threshold binarizes); at the default 0.5 the
        # binarized activations are equal. On the conversation one
        # activation lies 3.5e-6 below 0.5 (chunk 5, frame 188), so there
        # this equality rests on the two packages agreeing far closer than
        # ATOL, not on the margin
        assert np.array_equal(got.data > 0.5, want.data > 0.5)
    # the batch forward alone
    conv, half = fx.conversation(), FS // 2
    batch = np.stack([conv[i * half:i * half + js.win_samples]
                      for i in range(js.batch)])
    np.testing.assert_allclose(ts.forward(torch.from_numpy(batch)).numpy(),
                               np.asarray(js._forward(batch)), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="8000"):
        ts(np.zeros(FS, np.float32), 8000)


def test_dnn_vad_chunk_grid_invariance(jax_exps):
    """Absolute features and a stateless FIR memory: the core frames do not
    depend on the chunk grid."""
    vad_dir = jax_exps[0]
    wav = _test_wav(3)
    small = tvad.load_vad_exp(vad_dir, device="cpu", chunk_frames=64)
    big = tvad.load_vad_exp(vad_dir, device="cpu", chunk_frames=1024)
    p_small, _ = small.frame_probs(wav)
    p_big, _ = big.frame_probs(wav)
    assert p_small.shape == p_big.shape
    np.testing.assert_allclose(p_small, p_big, rtol=0, atol=1e-5)
    assert small(wav)[0] == big(wav)[0]


def test_short_and_empty_input(jax_exps):
    vad_dir, seg_dir = jax_exps[:2]
    tv = tvad.load_vad_exp(vad_dir, device="cpu")
    jv = jvad.load_vad_exp(vad_dir)
    for n in (0, 100, 399):  # shorter than one 400-sample frame
        flags, x = tv(np.full(n, 2.0, np.float32))
        assert flags == [] and x.shape == (n,) and np.all(x <= 1.0)
    silence = np.zeros(FS // 2, np.float32)
    assert tv(silence)[0] == jv(silence)[0]
    assert np.mean(tv(silence)[0]) < 0.5
    ts = tseg.load_segmentation_exp(seg_dir, device="cpu")
    js = jseg.load_segmentation_exp(seg_dir)
    for n in (0, 100, FS // 2):
        got, want = ts(np.zeros(n, np.float32)), js(np.zeros(n, np.float32))
        assert got.data.shape == want.data.shape == (1, ts.frames_per_win, 2)
        np.testing.assert_allclose(got.data, want.data, rtol=0, atol=ATOL)


def test_loaders_refuse(jax_exps, tmp_path):
    """No card: the loaders raise unless given the CPU; a directory without
    an experiment raises FileNotFoundError."""
    vad_dir, seg_dir = jax_exps[:2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tvad.load_vad_exp(vad_dir)
        with pytest.raises(RuntimeError, match="CUDA"):
            tseg.load_segmentation_exp(seg_dir)
    with pytest.raises(FileNotFoundError, match="config.yaml"):
        tvad.load_vad_exp(str(tmp_path / "none"), device="cpu")
    os.makedirs(tmp_path / "bare")
    with open(tmp_path / "bare" / "config.yaml", "w") as f:
        f.write("model: {args: {hidden_dim: 32}}\n")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tseg.load_segmentation_exp(str(tmp_path / "bare"), device="cpu")


def test_cli_dnn_front_identical_rttm(jax_exps):
    """The JAX-trained VAD and segmenter and a JAX-trained x-vector through
    both packages' diarization CLIs."""
    from speaker3d_tpu.cli.train import main as train_sv
    from speaker3d_tpu.utils.fileio import write_wav

    vad_dir, seg_dir, root, csv = jax_exps
    sv_cfg = fx.sv_config(root, csv)
    train_sv(["--config", sv_cfg])
    wav = os.path.join(root, "conv.wav")
    write_wav(wav, fx.conversation(), FS)
    fx.check_identical_rttm(fx.diarize_both(root, "jax_exps", wav,
                                            fx.exp_dir(sv_cfg), vad_dir,
                                            seg_dir))
