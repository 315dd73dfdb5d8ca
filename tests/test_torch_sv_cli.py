"""The port's speaker-verification CLIs (cli/extract.py, cli/infer_sv.py,
cli/infer_sv_batch.py) against the JAX package's, on the CPU.

Both packages load the same small random ERes2NetV2 in the 17.8M model's
geometry (scale 2, expansion 2, so the port's layer1-2 run the Res2-block
kernel's plain version), written as a reference-named checkpoint and
registered under the 17.8M id in both registries. The wavs are PCM16 on
disk: one shorter than a 400-sample frame, two short ones and one past a
10 s chunk. Embeddings are compared after dividing both by the reference's
largest magnitude, at rtol = atol = 3e-4 (fp32 sums taken in another order
over the trunk, as tests/test_torch_eres2netv2.py), and at cosine >= 0.9999.
"""

import os
import re

import numpy as np
import pytest
import torch

from speaker3d_tpu.cli import extract as jextract
from speaker3d_tpu.cli import infer_sv as jinfer_sv
from speaker3d_tpu.cli import infer_sv_batch as jbatch
from speaker3d_tpu.cli import registry as jreg
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu_torch.cli import extract as textract
from speaker3d_tpu_torch.cli import infer_sv as tinfer_sv
from speaker3d_tpu_torch.cli import infer_sv_batch as tbatch
from speaker3d_tpu_torch.cli import registry as treg
from speaker3d_tpu_torch.eval.chunking import embed_mean_over_plan, plan_chunks
from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
from speaker3d_tpu_torch.eval.scoring import load_embeddings
from speaker3d_tpu_torch.utils.fileio import load_audio, load_wav_scp, write_wav
from tests.test_torch_eres2netv2 import jax_variables, port_model
from tests.torch_threads import cap_torch_threads  # noqa: F401

MODEL_ID = "iic/speech_eres2netv2_sv_zh-cn_16k-common"
SMALL_17M = dict(num_blocks=(2, 2, 1, 1), m_channels=16, feat_dim=80,
                 embedding_size=32, base_width=26, scale=2, expansion=2)
FS = 16000
UTTS = [("short", 0.015), ("a", 0.6), ("b", 2.3), ("c", 12.5)]
BUCKETS = "1.5,3,6,10"


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("sv_cli")
    with pytest.MonkeyPatch.context() as mp:
        for key, val in SMALL_17M.items():
            mp.setitem(jreg.SUPPORTS[MODEL_ID]["model"]["args"], key, val)
            mp.setitem(treg.SUPPORTS[MODEL_ID]["model"]["args"], key, val)
        variables = jax_variables(JaxERes2NetV2(**SMALL_17M), seed=3)
        ckpt = (root / "pretrained" / MODEL_ID
                / treg.SUPPORTS[MODEL_ID]["model_pt"])
        os.makedirs(ckpt.parent)
        torch.save(port_model(variables, **SMALL_17M).state_dict(), ckpt)
        rng = np.random.default_rng(0)
        with open(root / "wav.scp", "w") as f:
            for utt, sec in UTTS:
                n = int(sec * FS)
                t = np.arange(n) / FS
                wav = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
                       + 0.05 * rng.standard_normal(n))
                write_wav(str(root / f"{utt}.wav"), wav, FS)
                f.write(f"{utt} {root / f'{utt}.wav'}\n")
        # the JAX extract CLI reads its checkpoint under ./pretrained
        mp.chdir(root)
        yield root


def _assert_match(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g / scale, w / scale, rtol=3e-4, atol=3e-4,
                                   err_msg=k)
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert cos >= 0.9999, (k, cos)


def _extract_both(work, name, *extra):
    args = ["--model_id", MODEL_ID, "--data", str(work / "wav.scp"),
            "--batch_size", "4", *extra]
    jextract.main(args + ["--out_dir", str(work / name / "jax")])
    textract.main(args + ["--out_dir", str(work / name / "port"), "--device",
                          "cpu", "--local_model_dir", str(work / "pretrained")])
    return (load_embeddings(str(work / name / "port")),
            load_embeddings(str(work / name / "jax")))


@pytest.mark.parametrize("out_type", ["npz", "ark"])
def test_extract_chunked_matches_jax(work, out_type):
    got, want = _extract_both(work, f"chunked_{out_type}", "--out_type",
                              out_type)
    _assert_match(got, want)
    name = ("embedding_0.ark" if out_type == "ark" else "embeddings_0.npz")
    assert sorted(os.listdir(work / f"chunked_{out_type}" / "port")) == sorted(
        os.listdir(work / f"chunked_{out_type}" / "jax"))
    assert (work / f"chunked_{out_type}" / "port" / name).is_file()


def test_extract_buckets_matches_jax(work):
    got, want = _extract_both(work, "buckets", "--buckets", BUCKETS)
    _assert_match(got, want)


def test_extract_exact_matches_jax(work, capsys):
    got, want = _extract_both(work, "exact", "--mode", "exact")
    # shorter than one frame: the JAX CLI writes NaN, the port skips it
    assert np.isnan(want.pop("short")).all()
    assert "[WARNING] skipping short" in capsys.readouterr().out
    _assert_match(got, want)


def test_extract_8khz_matches_jax(work):
    got, want = _extract_both(work, "rate8k", "--sample_rate", "8000")
    _assert_match(got, want)


def test_infer_sv_batch_npy_matches_jax(work, capsys):
    wav_list = work / "wavs.list"
    with open(wav_list, "w") as f:
        for utt, _ in UTTS:
            f.write(f"{work / utt}.wav\n")
        f.write(f"{work / 'missing.wav'}\n")
    args = ["--model_id", MODEL_ID, "--local_model_dir",
            str(work / "pretrained"), "--wavs", str(wav_list),
            "--batch_size", "4"]
    jbatch.main(args + ["--out_dir", str(work / "batch" / "jax")])
    tbatch.main(args + ["--out_dir", str(work / "batch" / "port"), "--device",
                        "cpu"])
    assert capsys.readouterr().out.count("[WARNING] skipping") == 2
    assert sorted(os.listdir(work / "batch" / "port")) == [
        f"{utt}.npy" for utt, _ in sorted(UTTS)]
    _assert_match(load_embeddings(str(work / "batch" / "port")),
                  load_embeddings(str(work / "batch" / "jax")))


def _verdict(out: str):
    cos = float(re.search(r"cosine similarity: (\S+)", out).group(1))
    return cos, re.search(r"same speaker: (\w+)", out).group(1)


def test_infer_sv_pair_matches_jax(work, capsys):
    args = ["--model_id", MODEL_ID, "--local_model_dir",
            str(work / "pretrained"), "--wavs", str(work / "a.wav"),
            str(work / "c.wav")]
    jinfer_sv.main(args + ["--save_dir", str(work / "pair" / "jax")])
    want = _verdict(capsys.readouterr().out)
    tinfer_sv.main(args + ["--save_dir", str(work / "pair" / "port"),
                           "--device", "cpu"])
    got = _verdict(capsys.readouterr().out)
    assert got[1] == want[1]
    assert abs(got[0] - want[0]) <= 1e-4
    _assert_match(load_embeddings(str(work / "pair" / "port")),
                  load_embeddings(str(work / "pair" / "jax")))


def test_chunked_batches_match_one_chunk_at_a_time(work):
    """Batched, bucketed extraction (batch padding, PCM16 wire) equals the
    plan embedded chunk by chunk (eval/chunking.py)."""
    model = treg.load_pretrained(MODEL_ID, str(work / "pretrained"))
    embed = build_embedding_fn(model, device="cpu", precision="highest")
    scp = load_wav_scp(str(work / "wav.scp"))
    buckets = [float(s) for s in BUCKETS.split(",")]
    got = textract.extract_embeddings(embed, scp, batch_size=3,
                                      bucket_seconds=buckets, device="cpu")
    want = {}
    for utt, path in scp.items():
        wav = load_audio(path, obj_fs=FS)[0]
        plan = plan_chunks(len(wav), sorted(int(b * FS) for b in buckets),
                           90 * FS)
        want[utt] = embed_mean_over_plan(embed, wav, plan)
    _assert_match(got, want)


@pytest.mark.parametrize("cli", [textract, tbatch])
def test_exp_dir_is_refused_naming_m12(cli, tmp_path):
    """``--exp_dir`` is open since the trainer (M12) was ported
    (tests/test_torch_train_cli.py); a directory that holds no experiment
    is refused loudly."""
    argv = ["--exp_dir", str(tmp_path), "--out_dir", str(tmp_path),
            "--device", "cpu"]
    argv += (["--data", "wav.scp"] if cli is textract else ["--wavs", "x"])
    with pytest.raises(FileNotFoundError, match="config.yaml"):
        cli.main(argv)
