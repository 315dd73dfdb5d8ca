"""The PyTorch port's diarization pipeline and CLI against the JAX package's:
identical RTTM bytes on the two-speaker audio of tests/test_diar_pipeline.py
with the same small random ERes2NetV2 w24s4ep4-geometry weights in both, and
the resident-waveform gather against the JAX host slice/pad/stack path."""

import os

import numpy as np
import pytest
import torch

from speaker3d_tpu.cli import infer_diarization as jcli
from speaker3d_tpu.cli import registry as jreg
from speaker3d_tpu.diar.pipeline import DiarizationPipeline as JaxPipeline
from speaker3d_tpu.diar.pipeline import _gather_chunks_jit
from speaker3d_tpu.eval.embedding import build_embedding_fn as jax_embedding_fn
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu_torch.cli import infer_diarization as tcli
from speaker3d_tpu_torch.cli import registry as treg
from speaker3d_tpu_torch.diar.pipeline import (
    DiarizationPipeline, circle_pad, compressed_seg, gather_chunks,
    sliding_chunks)
from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
from speaker3d_tpu_torch.utils.fileio import write_wav
from tests.test_diar_pipeline import _two_speaker_wav
from tests.test_torch_eres2netv2 import jax_variables, port_model

FS = 16000
MODEL_ID = "iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common"
SMALL_W24 = dict(num_blocks=(2, 2, 1, 1), m_channels=16, feat_dim=80,
                 embedding_size=32, base_width=24, scale=4, expansion=4)
# Random weights embed every chunk of this audio at cosine > 0.95; the two
# tones sit at <= 0.955 across and >= 0.977 within, so a cut between splits
# them and the RTTMs carry two speakers
COS_THR = 0.966


@pytest.fixture(scope="module")
def weights():
    jm = JaxERes2NetV2(**SMALL_W24)
    return jm, jax_variables(jm, seed=4)


def _rttm(pipe, fields, path):
    pipe.save_diar_output(path, wav_id="utt1", output_field_labels=fields)
    with open(path, "rb") as f:
        return f.read()


def test_pipeline_rttm_bytes_equal_jax(weights, tmp_path):
    jm, variables = weights
    wav, _, fs = _two_speaker_wav()
    thr = dict(cluster_mer_cos=COS_THR, cluster_fix_cos_thr=COS_THR)
    jpipe = JaxPipeline(jax_embedding_fn(jm, variables, precision="high"),
                        sample_rate=fs, **thr)
    tpipe = DiarizationPipeline(
        build_embedding_fn(port_model(variables, **SMALL_W24), device="cpu",
                           precision="high"), sample_rate=fs, device="cpu",
        **thr)
    jfields, tfields = jpipe(wav), tpipe(wav)
    assert len({f[2] for f in tfields}) == 2
    assert tpipe.last_chunks == jpipe.last_chunks
    scale = np.abs(jpipe.last_embeddings).max()
    np.testing.assert_allclose(tpipe.last_embeddings / scale,
                               jpipe.last_embeddings / scale,
                               rtol=3e-4, atol=3e-4)
    assert (_rttm(tpipe, tfields, str(tmp_path / "t.rttm"))
            == _rttm(jpipe, jfields, str(tmp_path / "j.rttm")))
    assert tpipe.last_wire == {"dtype": "float32", "bytes": 4 * len(wav)}
    assert set(tpipe.last_stage_times) >= {"vad", "vad_post", "embed",
                                           "cluster"}


def test_cli_rttm_bytes_equal_jax(weights, tmp_path, monkeypatch):
    jm, variables = weights
    for key, val in SMALL_W24.items():
        monkeypatch.setitem(jreg.SUPPORTS[MODEL_ID]["model"]["args"], key, val)
        monkeypatch.setitem(treg.SUPPORTS[MODEL_ID]["model"]["args"], key, val)
    ckpt = tmp_path / "pretrained" / MODEL_ID / treg.SUPPORTS[MODEL_ID]["model_pt"]
    os.makedirs(ckpt.parent)
    torch.save(port_model(variables, **SMALL_W24).state_dict(), ckpt)
    wav, _, fs = _two_speaker_wav()
    # PCM16 on disk, so both pipelines ship the int16 wire
    wav_path = str(tmp_path / "conv.wav")
    write_wav(wav_path, wav, fs)
    common = ["--wav", wav_path, "--local_model_dir",
              str(tmp_path / "pretrained"), "--cluster_mer_cos", str(COS_THR),
              "--cluster_fix_cos_thr", str(COS_THR)]
    jcli.main(common + ["--out_dir", str(tmp_path / "jax")])
    tcli.main(common + ["--out_dir", str(tmp_path / "torch"), "--device",
                        "cpu"])
    with open(tmp_path / "jax" / "conv.rttm", "rb") as f:
        want = f.read()
    with open(tmp_path / "torch" / "conv.rttm", "rb") as f:
        got = f.read()
    assert got == want
    assert len({line.split()[7] for line in got.splitlines()}) == 2


def test_cli_refuses_unported_flags(tmp_path):
    """The flags whose modules wait for the trainer's experiment layout
    (M12, M11b); --cluster_type spectral|umap_hdbscan run since they were
    ported (tests/test_torch_diar_cli_extra.py)."""
    for extra in (["--exp_dir", "x"], ["--vad_exp_dir", "x"],
                  ["--include_overlap"]):
        with pytest.raises(SystemExit, match="not ported"):
            tcli.main(["--wav", "a.wav", "--out_dir", str(tmp_path),
                       "--device", "cpu"] + extra)


def test_registry_refuses_unported_ids_and_missing_checkpoints(tmp_path):
    """Every JAX id builds in the port (none is refused as unported any
    more); an unknown id and a missing checkpoint are still refused."""
    assert set(treg.SUPPORTS) == set(jreg.SUPPORTS)
    for model_id in jreg.SUPPORTS:
        assert isinstance(treg.build_model(model_id), torch.nn.Module)
    with pytest.raises(KeyError, match="not supported"):
        treg.build_model("iic/no_such_model")
    with pytest.raises(FileNotFoundError, match="no network egress"):
        treg.load_pretrained(MODEL_ID, str(tmp_path))


def _identity(wavs):
    # embeddings ARE the chunk waveforms: any slicing/padding deviation
    # from the host path shows up as a bitwise mismatch
    return wavs


def _pcm16_wav(n, seed=0):
    k = np.random.default_rng(seed).integers(-32768, 32768, size=n)
    return k.astype(np.int16).astype(np.float32) / 32768.0


@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_device_gather_matches_jax_host_path(wire):
    if wire == "int16":
        wav = _pcm16_wav(int(7.3 * FS))
    else:
        wav = (np.random.default_rng(1).standard_normal(int(7.3 * FS)) * 0.1
               ).astype(np.float32)
    pipe = DiarizationPipeline(_identity, batch_size=4, device="cpu")
    ref = JaxPipeline(_identity, batch_size=4)
    L = int(pipe.chunk_dur * FS)
    # full windows, a short leftover (circle-pad), an empty chunk, and
    # enough chunks to need batch padding
    chunks = [[0.0, 1.5], [0.75, 2.25], [1.5, 3.0], [6.9, 7.3],
              [2.0, 2.0], [3.0, 4.5], [4.0, 5.5]]
    bounds = [(int(st * FS), int(ed * FS)) for st, ed in chunks]
    got = pipe.do_emb_extraction(chunks, wav)
    assert pipe.last_wire["dtype"] == wire
    assert np.array_equal(got, ref._emb_extraction_host(bounds, wav, L))


def _overshoot_chunks():
    """Three chunks, one of them a sliding window that ``int(t * FS)``
    rounds to 1.5 s + 1 sample (VAD intervals start on sample times k / FS)."""
    st = next(s for s in (k / FS for k in range(FS))
              if int((s + 1.5) * FS) - int(s * FS) == int(1.5 * FS) + 1)
    return [[0.0, 1.5], [st, st + 1.5], [2.0, 2.5]]


@pytest.mark.parametrize("chunks,pad_len", [
    ([[0.5, 4.5], [5.0, 5.6]], 72000),   # whole segments (.pairs.json)
    ("overshoot", 48000),                # one window of 1.5 s + 1 sample
    ([[0.2, 0.9], [2.0, 2.5]], 24000),   # every chunk shorter than 1.5 s
])
def test_device_gather_pads_like_jax_pipeline(chunks, pad_len):
    """Both pipelines circle-pad every chunk of a call to chunk_dur, or to
    the longest chunk rounded up to a multiple of chunk_dur."""
    if chunks == "overshoot":
        chunks = _overshoot_chunks()
    wav = _pcm16_wav(int(6.0 * FS), seed=2)
    pipe = DiarizationPipeline(_identity, batch_size=4, device="cpu")
    got = pipe.do_emb_extraction(chunks, wav)
    want = JaxPipeline(_identity, batch_size=4).do_emb_extraction(chunks, wav)
    assert got.shape == (len(chunks), pad_len) and np.array_equal(got, want)
    assert pipe.last_pad_len == pad_len


def test_overshoot_embeddings_equal_jax(weights):
    jm, variables = weights
    wav = (np.random.default_rng(5).standard_normal(int(4.0 * FS)) * 0.1
           ).astype(np.float32)
    chunks = _overshoot_chunks()
    jpipe = JaxPipeline(jax_embedding_fn(jm, variables, precision="high"),
                        batch_size=4)
    tpipe = DiarizationPipeline(
        build_embedding_fn(port_model(variables, **SMALL_W24), device="cpu",
                           precision="high"), batch_size=4, device="cpu")
    want = jpipe.do_emb_extraction(chunks, wav)
    got = tpipe.do_emb_extraction(chunks, wav)
    assert tpipe.last_pad_len == 2 * int(1.5 * FS)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=3e-4,
                               atol=3e-4)


def test_gather_edges_equal_jax_gather():
    wav = np.arange(32, dtype=np.float32)
    starts = np.asarray([0, 4, 10], np.int32)
    lens = np.asarray([3, 0, 8], np.int32)
    got = gather_chunks(torch.from_numpy(wav), torch.from_numpy(starts).long(),
                        torch.from_numpy(lens).long(), 6).numpy()
    want = np.asarray(_gather_chunks_jit()(wav, starts, lens, 6))
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], [0, 1, 2, 0, 1, 2])   # circle-pad
    assert np.array_equal(got[1], np.zeros(6))           # empty -> zeros
    w16 = torch.from_numpy(_pcm16_wav(64, seed=3) * 32768).to(torch.int16)
    out = gather_chunks(w16, torch.tensor([5]), torch.tensor([7]), 10)
    assert torch.equal(out[0], (w16[5 + torch.arange(10) % 7].float() / 32768))
    empty = gather_chunks(torch.zeros(0), torch.tensor([0]), torch.tensor([0]), 4)
    assert torch.equal(empty, torch.zeros((1, 4)))


def test_resident_upload_cached_per_object_and_empty_audio():
    wav = _pcm16_wav(2 * FS, seed=3)
    pipe = DiarizationPipeline(_identity, device="cpu")
    d1 = pipe.resident_wav(wav)
    assert pipe.resident_wav(wav) is d1
    assert pipe.resident_wav(wav.copy()) is not d1
    assert pipe.last_wire == {"dtype": "int16", "bytes": 2 * len(wav)}
    assert pipe(np.zeros(16000, np.float32)) == []
    assert pipe.last_wire["bytes"] == 2 * 16000  # no slab padding


def test_chunking_helpers():
    assert np.allclose(circle_pad(np.array([1.0, 2.0, 3.0]), 7),
                       [1, 2, 3, 1, 2, 3, 1])
    assert sliding_chunks(0.0, 0.5, 1.5, 0.75) == [[0.0, 0.5]]
    assert sliding_chunks(1.0, 1.0, 1.5, 0.75) == []
    assert compressed_seg([[0, 2.0, 0], [1.0, 3.0, 1]]) == [[0, 1.5, 0],
                                                           [1.5, 3.0, 1]]
