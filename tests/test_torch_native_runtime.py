"""The port's native runtime (speaker3d_tpu_torch/runtime, built by
runtime/build.py with g++ and no cmake) on the CPU.

A module fixture builds the CPU runtime (no CUDA) while it compiles one
AOTInductor package (a 0.5 s bucket) of a small ERes2NetV2 in the 17.8M
model's geometry, whose layer1-2 blocks call ``s3d::res2_block``. Then:
the native fbank against the port's ``KaldiFbank`` at the JAX runtime
test's atol = 2e-3, rtol = 1e-3 (tests/test_native_runtime.py); the chunk
plan in lockstep with both packages' ``plan_chunks``; the C++ operator's
schema equal to the Python one; ``extract_speaker_embedding --engine aot
--device cpu`` (libtorch alone, the operator registered in C++) against the
port's Python path with the same chunk plan, and ``--engine bridge
--device cpu`` (embedded CPython) against ``extract --mode exact``, both at
cosine >= 0.9999 (the host fbank against the port's, in float32).
"""

import os
import subprocess
import threading

import numpy as np
import pytest
import torch
import yaml

from speaker3d_tpu.eval.chunking import plan_chunks as jax_plan_chunks
from speaker3d_tpu_torch.cli import export_speaker_embedding as tex
from speaker3d_tpu_torch.cli import extract as textract
from speaker3d_tpu_torch.eval.chunking import embed_mean_over_plan, plan_chunks
from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
from speaker3d_tpu_torch.eval.scoring import load_embeddings
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk
from speaker3d_tpu_torch.runtime import build as runtime_build
from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
from speaker3d_tpu_torch.utils.fileio import load_audio, read_wav, write_wav
from tests.torch_threads import cap_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_blocks=[1, 1, 1, 1], m_channels=8, feat_dim=80,
             embedding_size=16, base_width=26, scale=2, expansion=2)
FS = 16000
BUCKET_S = 0.5
# one shorter than a 400-sample frame, a short one, one of two chunks
UTTS = [("short", 0.015), ("a", 0.3), ("b", 0.8)]
COS = 0.9999


def _random_bn(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.from_numpy(
                    0.1 * rng.standard_normal(t.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    built = {}
    builder = threading.Thread(
        target=lambda: built.update(dir=runtime_build.build(cuda=False)))
    builder.start()
    root = str(tmp_path_factory.mktemp("native"))
    torch.manual_seed(0)
    model = _random_bn(ERes2NetV2(**SMALL).eval(), 1)
    exp = os.path.join(root, "exp")
    os.makedirs(exp)
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.safe_dump({"model": {
            "obj": "speaker3d_tpu.models.eres2netv2.ERes2NetV2",
            "args": SMALL}}, f)
    Checkpointer(os.path.join(exp, "models")).save_checkpoint(
        1, {"train_state": {"model": {k: v.numpy() for k, v in
                                      model.state_dict().items()}}})
    aot = os.path.join(root, "aot")
    tex.export_aot_artifact(model, aot, bucket_seconds=[BUCKET_S],
                            device="cpu")
    rng = np.random.default_rng(2)
    scp = os.path.join(root, "wav.scp")
    with open(scp, "w") as f:
        for i, (utt, sec) in enumerate(UTTS):
            n = int(sec * FS)
            t = np.arange(n) / FS
            wav = (0.3 * np.sin(2 * np.pi * (150 + 90 * i) * t)
                   + 0.01 * rng.standard_normal(n)).astype(np.float32)
            write_wav(os.path.join(root, f"{utt}.wav"), wav, FS)
            f.write(f"{utt} {os.path.join(root, utt)}.wav\n")
    builder.join()
    return {"bin": built["dir"], "root": root, "exp": exp, "aot": aot,
            "scp": scp, "model": model}


def _run(native, name, *args, check=True):
    return subprocess.run([os.path.join(native["bin"], name), *args],
                          capture_output=True, text=True, check=check,
                          timeout=300)


def _read_embs(folder):
    return {fn[:-4]: np.loadtxt(os.path.join(folder, fn))
            for fn in os.listdir(folder) if fn.endswith(".emb")}


def _min_cos(got, want):
    assert sorted(got) == sorted(want)
    return min(float(got[k] @ want[k] / np.linalg.norm(got[k])
                     / np.linalg.norm(want[k])) for k in want)


def test_native_fbank_matches_port_fbank(native, tmp_path):
    wav = (np.random.default_rng(0).standard_normal(16000) * 0.1).astype(
        np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, wav, FS)
    out = str(tmp_path / "feats.txt")
    _run(native, "make_fbank_feature", path, out, "--mean_norm")
    got = np.loadtxt(out)
    decoded, _ = read_wav(path)
    want = KaldiFbank(FbankConfig(), mean_norm=True, device="cpu")(
        torch.as_tensor(np.asarray(decoded[0]))).numpy()
    assert got.shape == want.shape == (98, 80)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_read_and_describe_wav(native, tmp_path):
    wav = np.sin(2 * np.pi * 440 * np.arange(8000) / FS).astype(np.float32)
    path = str(tmp_path / "tone.wav")
    write_wav(path, wav * 0.5, FS)
    out = _run(native, "read_and_describe_wav", path).stdout
    assert "sample_rate: 16000" in out and "duration_s: 0.500" in out


def test_chunk_plan_in_lockstep_with_both_packages(native):
    buckets = [24000, 48000, 96000, 160000]
    for n in (0, 1, 7000, 24000, 24001, 159999, 160000, 160001, 500000,
              160000 * 9 + 1, 160000 * 20):
        want = plan_chunks(n, buckets, 90 * FS)
        assert want == jax_plan_chunks(n, buckets, 90 * FS)
        out = _run(native, "print_chunk_plan", str(n), str(90 * FS),
                   *map(str, buckets)).stdout
        assert [tuple(int(v) for v in line.split())
                for line in out.splitlines()] == [tuple(c) for c in want], n


def test_cxx_operator_schema_equals_python(native):
    got = _run(native, "print_op_schema").stdout.strip()
    assert got == str(torch.ops.s3d.res2_block.default._schema)
    assert got == "s3d::" + rk.SCHEMA


def test_aot_engine_on_cpu_matches_the_python_plan(native, tmp_path):
    """libtorch runs the bucket package, s3d::res2_block registered in C++:
    each utterance in 0.5 s chunks circle-padded to the bucket, averaged;
    the port's Python path embeds the same plan (the short utterance too)."""
    out = str(tmp_path / "emb")
    os.makedirs(out)
    proc = _run(native, "extract_speaker_embedding", native["scp"], out,
                native["aot"], "--engine", "aot", "--device", "cpu")
    assert "RTF" in proc.stderr and "res2_block launches: 0 0" in proc.stderr
    embed = build_embedding_fn(native["model"], device="cpu",
                               precision="high")
    want = {}
    for utt, _ in UTTS:
        wav = np.asarray(load_audio(os.path.join(native["root"],
                                                 f"{utt}.wav"),
                                    obj_fs=FS)[0])
        want[utt] = embed_mean_over_plan(embed, wav, plan_chunks(
            len(wav), [int(BUCKET_S * FS)], 90 * FS))
    assert _min_cos(_read_embs(out), want) >= COS


def test_bridge_engine_on_cpu_matches_extract_exact(native, tmp_path):
    """The embedded interpreter runs runtime_bridge on the CPU; the
    utterance shorter than a frame is skipped, as extract --mode exact
    skips it."""
    out, ref = str(tmp_path / "emb"), str(tmp_path / "ref")
    os.makedirs(out)
    proc = _run(native, "extract_speaker_embedding", native["scp"], out,
                native["exp"], "--engine", "bridge", "--device", "cpu",
                "--repo_root", ROOT)
    assert "skipping short" in proc.stderr and "RTF" in proc.stderr
    textract.main(["--exp_dir", native["exp"], "--data", native["scp"],
                   "--out_dir", ref, "--mode", "exact", "--device", "cpu"])
    want = {k: v.astype(np.float64) for k, v in load_embeddings(ref).items()}
    assert sorted(want) == ["a", "b"]
    assert _min_cos(_read_embs(out), want) >= COS


@pytest.mark.parametrize("args, says", [
    (["--engine", "aot", "--plugin", "/x/libpjrt.so"], "libtorch"),
    (["--engine", "aot", "--device", "cuda"], "compiled for device 'cpu'"),
    (["--engine", "onnx"], "--engine must be bridge or aot"),
    (["--engine", "aot", "--device", "tpu"], "--device must be cuda or cpu"),
])
def test_cli_refuses(native, tmp_path, args, says):
    proc = _run(native, "extract_speaker_embedding", native["scp"],
                str(tmp_path), native["aot"], *args, check=False)
    assert proc.returncode == 1 and says in proc.stderr
