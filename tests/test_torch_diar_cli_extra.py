"""The PyTorch port's diarization CLI with spectral and UMAP+HDBSCAN
clustering, and its ``check_single_speaker`` and ``analyze_similarity``
CLIs, against the JAX package's CLIs on the same weights (the small
w24s4ep4-geometry ERes2NetV2 of tests/test_torch_pipeline.py, saved as a
reference-named checkpoint that both registries load).

The conversation alternates the two tones of
tests/test_diar_pipeline.py::_two_speaker_wav over ~45 s, so the pipeline
embeds more than ``cluster_line`` = 40 chunks and ``CommonClustering``
runs the asked-for clusterer, not its short-input AHC. Segment times must
be equal and speaker labels equal up to one renaming: label numbers follow
k-means' numbering, and the JAX CLI without a seed is not reproducible run
to run.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from speaker3d_tpu.cli import analyze_similarity as j_analyze
from speaker3d_tpu.cli import check_single_speaker as j_check
from speaker3d_tpu.cli import infer_diarization as j_diar
from speaker3d_tpu.cli import registry as jreg
from speaker3d_tpu_torch.cli import analyze_similarity as t_analyze
from speaker3d_tpu_torch.cli import check_single_speaker as t_check
from speaker3d_tpu_torch.cli import infer_diarization as t_diar
from speaker3d_tpu_torch.cli import registry as treg
from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline
from speaker3d_tpu_torch.utils.fileio import write_wav
from tests.test_torch_eres2netv2 import port_model
from tests.test_torch_pipeline import COS_THR, MODEL_ID, SMALL_W24

FS = 16000


def _conversation(seconds=(4.0, 4.0, 3.0, 3.5, 4.0, 4.0, 3.5, 3.0, 4.0, 4.0)):
    """Turns of the 220 Hz and 2,000 Hz tones of _two_speaker_wav (speaker
    A, then B, alternating), 0.8 s of silence around each; PCM16-exact."""
    rng = np.random.default_rng(0)

    def tone(freq, dur):
        t = np.arange(int(dur * FS)) / FS
        sig = np.sin(2 * np.pi * freq * t)
        sig += 0.3 * np.sin(2 * np.pi * 2 * freq * t + 1.0)
        return 0.3 * sig + 0.01 * rng.standard_normal(len(t))

    sil = np.zeros(int(0.8 * FS))
    parts = [sil]
    for i, dur in enumerate(seconds):
        parts += [tone((220, 2000)[i % 2], dur), sil]
    wav = np.concatenate(parts)
    return (np.round(np.clip(wav, -1, 1 - 1 / 32768) * 32768) / 32768).astype(
        np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The checkpoint under a model dir, and the conversation as a wav."""
    from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
    from tests.test_torch_eres2netv2 import jax_variables

    root = tmp_path_factory.mktemp("diar_extra")
    variables = jax_variables(JaxERes2NetV2(**SMALL_W24), seed=4)
    ckpt = root / "pretrained" / MODEL_ID / treg.SUPPORTS[MODEL_ID]["model_pt"]
    os.makedirs(ckpt.parent)
    torch.save(port_model(variables, **SMALL_W24).state_dict(), ckpt)
    wav = _conversation()
    wav_path = str(root / "conv.wav")
    write_wav(wav_path, wav, FS)
    return root, wav, wav_path


@pytest.fixture
def small_registry(monkeypatch):
    for key, val in SMALL_W24.items():
        monkeypatch.setitem(jreg.SUPPORTS[MODEL_ID]["model"]["args"], key, val)
        monkeypatch.setitem(treg.SUPPORTS[MODEL_ID]["model"]["args"], key, val)


def test_conversation_gives_more_chunks_than_cluster_line(setup):
    _, wav, _ = setup
    pipe = DiarizationPipeline(lambda w: w[:, :8], device="cpu")
    pipe(wav)
    assert len(pipe.last_chunks) >= 40


def _rttm_rows(path):
    with open(path) as f:
        rows = [line.split() for line in f]
    return [(r[3], r[4]) for r in rows], [r[7] for r in rows]


# (flags, speakers in the RTTM): spectral finds the two tones. UMAP+HDBSCAN
# at the CLI's settings (60 components, 20 neighbours, min_samples 20)
# labels every one of these ~46 chunks noise, in both packages: one speaker
# '-1', which AHC never writes, so the RTTM shows the UMAP path ran (its
# partitions on separated data: tests/test_torch_umap_hdbscan.py)
@pytest.mark.parametrize("extra,speakers", [
    (["--cluster_type", "spectral", "--cluster_seed", "0"], 2),
    (["--cluster_type", "spectral", "--cluster_seed", "0",
      "--cluster_backend", "device"], 2),
    (["--cluster_type", "spectral", "--cluster_seed", "0",
      "--cluster_pval", "0.1", "--speaker_num", "2"], 2),
    (["--cluster_type", "umap_hdbscan"], {"-1"}),
], ids=["spectral_numpy", "spectral_device", "spectral_oracle_pval",
        "umap_hdbscan"])
def test_cli_segments_equal_jax(setup, small_registry, extra, speakers):
    root, _, wav_path = setup
    common = ["--wav", wav_path, "--local_model_dir", str(root / "pretrained"),
              "--cluster_mer_cos", str(COS_THR)] + extra
    name = "_".join(extra[1::2])
    # the JAX CLI's device choice is 'jax'
    j_extra = ["jax" if a == "device" else a for a in common]
    j_diar.main(j_extra + ["--out_dir", str(root / f"jax_{name}")])
    t_diar.main(common + ["--out_dir", str(root / f"torch_{name}"),
                          "--device", "cpu"])
    t_times, t_spk = _rttm_rows(root / f"torch_{name}" / "conv.rttm")
    j_times, j_spk = _rttm_rows(root / f"jax_{name}" / "conv.rttm")
    assert t_times == j_times
    renaming = {}
    for a, b in zip(t_spk, j_spk):
        assert renaming.setdefault(a, b) == b
    assert len(set(renaming.values())) == len(renaming)
    assert (len(renaming) == speakers if isinstance(speakers, int)
            else set(t_spk) == set(j_spk) == speakers)


def test_cli_still_refuses_unported_flags(tmp_path):
    for extra, item in ((["--vad_exp_dir", "x"], "M11b"),
                        (["--include_overlap"], "M11b"),
                        (["--exp_dir", "x"], "M12")):
        with pytest.raises(SystemExit, match=f"not ported.*{item}"):
            t_diar.main(["--wav", "a.wav", "--out_dir", str(tmp_path),
                         "--device", "cpu"] + extra)


def _numbers_close(got, want, tol):
    """Equal structure and keys in the same order; floats within tol."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _numbers_close(got[k], want[k], tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _numbers_close(g, w, tol)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= tol, (got, want)
    else:
        assert got == want


def test_check_single_speaker_equals_jax(setup, small_registry, tmp_path):
    root, wav, _ = setup
    single = str(tmp_path / "single.wav")
    write_wav(single, wav[:int(5.6 * FS)], FS)  # speaker A's first turn
    common = ["--local_model_dir", str(root / "pretrained"), "--threshold",
              "0.97"]
    results = {}
    for name, cli, extra in (("jax", j_check, []),
                             ("torch", t_check, ["--device", "cpu"])):
        out_dir = tmp_path / name
        list_path = tmp_path / f"{name}.list"
        list_path.write_text(f"{single}\n{root / 'conv.wav'}\n")
        cli.main(["--wav", str(list_path), "--out", str(tmp_path / f"{name}.json"),
                  "--out_dir", str(out_dir)] + common + extra)
        with open(tmp_path / f"{name}.json") as f:
            results[name] = json.load(f)
        assert sorted(os.listdir(out_dir)) == ["conv.single_spk.json",
                                               "single.single_spk.json"]
    got, want = results["torch"], results["jax"]
    _numbers_close(got, want, 3e-4)
    assert [r["is_single_speaker"] for r in got] == [True, False]
    with pytest.raises(SystemExit, match="M12"):
        t_check.main(["--wav", single, "--exp_dir", "x", "--device", "cpu"])


def test_analyze_similarity_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    # speakers s and s + 3 share a base voice: similar pairs across datasets
    base = rng.standard_normal((3, 32))
    centers = base[np.arange(6) % 3] + 0.6 * rng.standard_normal((6, 32))
    emb = {f"ds{s % 2}_spk{s}_u{u}": (centers[s] + 0.3 * rng.standard_normal(
        32)).astype(np.float32) for s in range(6) for u in range(3)}
    np.savez(tmp_path / "emb.npz", **emb)
    utt2spk = tmp_path / "utt2spk"
    utt2spk.write_text("".join(f"{k} {k.rsplit('_', 1)[0]}\n" for k in emb))
    for level, extra in (("speaker", ["--prefix_as", "1"]),
                         ("utt", ["--min_similarity", "0.2"])):
        outs = {}
        for name, cli, dev in (("jax", j_analyze, []),
                               ("torch", t_analyze, ["--device", "cpu"])):
            out = tmp_path / f"{name}_{level}"
            assert cli.main(["--emb", str(tmp_path / "emb.npz"), "--out_dir",
                             str(out), "--utt2spk", str(utt2spk), "--level",
                             level] + extra + dev) == 0
            outs[name] = out
        with open(outs["torch"] / "speaker_similarity.json") as f:
            got = json.load(f)
        with open(outs["jax"] / "speaker_similarity.json") as f:
            want = json.load(f)
        _numbers_close(got, want, 1e-6)
        assert got["num_pairs_above_threshold"] > 0
        assert got["num_cross_dataset_pairs"] > 0 or level == "utt"
        np.testing.assert_allclose(
            np.load(outs["torch"] / "similarity_matrix.npy"),
            np.load(outs["jax"] / "similarity_matrix.npy"), rtol=0, atol=1e-6)
        with open(outs["torch"] / "similarity_analysis.csv") as f:
            t_rows = list(csv.reader(f))
        with open(outs["jax"] / "similarity_analysis.csv") as f:
            j_rows = list(csv.reader(f))
        assert [r[:2] + r[3:] for r in t_rows] == [r[:2] + r[3:]
                                                   for r in j_rows]
