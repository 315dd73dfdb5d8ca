"""The port's speaker-verification host modules against the JAX package's,
on the CPU: the chunk plan (eval/chunking.py), the Kaldi ark/scp writer and
readers (utils/kaldi_ark.py), the metrics (utils/metrics.py), the embedding
stores and trial scoring (eval/scoring.py), the per-rank naming
(parallel/mesh.py, utils/fileio.py) and the scoring CLI
(cli/compute_score_metrics.py). Inputs are made from a numpy seed.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from speaker3d_tpu.cli import compute_score_metrics as jscore_cli
from speaker3d_tpu.eval import chunking as jchunking
from speaker3d_tpu.eval import scoring as jscoring
from speaker3d_tpu.utils import fileio as jfileio
from speaker3d_tpu.utils import kaldi_ark as jark
from speaker3d_tpu.utils import metrics as jmetrics
from speaker3d_tpu_torch.cli import compute_score_metrics as tscore_cli
from speaker3d_tpu_torch.eval import chunking as tchunking
from speaker3d_tpu_torch.eval import scoring as tscoring
from speaker3d_tpu_torch.parallel import mesh
from speaker3d_tpu_torch.utils import fileio as tfileio
from speaker3d_tpu_torch.utils import kaldi_ark as tark
from speaker3d_tpu_torch.utils import metrics as tmetrics
from tests.torch_threads import cap_torch_threads  # noqa: F401


@settings(max_examples=200, deadline=None)
@given(n=st.integers(-5, 2_000_000),
       buckets=st.lists(st.integers(400, 200_000), min_size=0, max_size=5,
                        unique=True),
       cap=st.integers(1, 1_600_000))
def test_plan_chunks_equals_jax(n, buckets, cap):
    buckets = sorted(buckets)
    got = tchunking.plan_chunks(n, buckets, cap)
    assert got == jchunking.plan_chunks(n, buckets, cap)
    assert [tuple(c) for c in got] == [
        tuple(c) for c in jchunking.plan_chunks(n, buckets, cap)]


def test_plan_chunks_cap_and_buckets():
    fs = 16000
    plan = tchunking.plan_chunks(95 * fs, [10 * fs], 90 * fs)
    assert len(plan) == 9 and plan[-1] == (80 * fs, 10 * fs, 10 * fs)
    bucketed = tchunking.plan_chunks(int(12.5 * fs), [24000, 48000, 96000,
                                                      160000], 90 * fs)
    assert [c.padded for c in bucketed] == [160000, 48000]


def test_embed_mean_over_plan_equals_jax():
    rng = np.random.default_rng(0)
    wav = rng.standard_normal(50_000).astype(np.float32)
    plan = tchunking.plan_chunks(len(wav), [8000, 16000], 40_000)

    def embed(x):  # [1, L] -> [1, 3]: a function of every sample
        return np.stack([x.sum(-1), (x ** 2).sum(-1), x[..., ::7].sum(-1)], -1)

    np.testing.assert_array_equal(
        tchunking.embed_mean_over_plan(embed, wav, plan),
        jchunking.embed_mean_over_plan(embed, wav, plan))


def _embeddings(seed, n=12, d=16, prefix="u"):
    rng = np.random.default_rng(seed)
    return {f"{prefix}{i}": rng.standard_normal(d).astype(np.float32)
            for i in range(n)}


def test_kaldi_ark_bytes_equal_jax_and_readers_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    data = {**_embeddings(1), "mat": rng.standard_normal((3, 5)).astype(
        np.float32), "f64": rng.standard_normal(4)}
    paths = {}
    for name, mod in (("port", tark), ("jax", jark)):
        ark, scp = tmp_path / f"{name}.ark", tmp_path / f"{name}.scp"
        mod.write_ark_scp(str(ark), data, str(scp))
        paths[name] = (ark, scp)
    assert paths["port"][0].read_bytes() == paths["jax"][0].read_bytes()
    scp_lines = paths["port"][1].read_text().replace("port.ark", "jax.ark")
    assert scp_lines == paths["jax"][1].read_text()
    for reader in (tark, jark):
        for ark, scp in paths.values():
            for got in (reader.read_ark(str(ark)), reader.read_scp(str(scp))):
                assert list(got) == list(data)
                for k, v in data.items():
                    np.testing.assert_array_equal(got[k], v.astype(np.float32))
    with pytest.raises(ValueError):
        tark.write_ark_scp(str(tmp_path / "bad.ark"), {"a b": data["u0"]})


def test_kaldi_ark_reads_float64_records(tmp_path):
    import struct

    v = np.random.default_rng(2).standard_normal(6)
    with open(tmp_path / "d.ark", "wb") as f:
        f.write(b"k \0BDV \x04" + struct.pack("<i", 6) + v.tobytes())
    got = tark.read_ark(str(tmp_path / "d.ark"))
    assert got["k"].dtype == np.float64
    np.testing.assert_array_equal(got["k"], v)


def _score_sets():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 2, 400)
    noisy = rng.standard_normal(400) + 1.5 * labels
    yield "random", noisy, labels
    yield "separated", np.where(labels == 1, 0.9, 0.1) + 0.01 * rng.random(
        400), labels
    yield "tied", np.full(400, 0.5), labels
    yield "tiny", np.asarray([0.2, 0.8]), np.asarray([0, 1])


@pytest.mark.parametrize("case", [c[0] for c in _score_sets()])
def test_metrics_equal_jax(case):
    scores, labels = next((s, y) for name, s, y in _score_sets()
                          if name == case)
    fnr, fpr = tmetrics.fnr_fpr_curve(scores, labels)
    jfnr, jfpr = jmetrics.fnr_fpr_curve(scores, labels)
    np.testing.assert_allclose(fnr, jfnr, rtol=0, atol=1e-12)
    np.testing.assert_allclose(fpr, jfpr, rtol=0, atol=1e-12)
    got = tmetrics.compute_eer(scores, labels, return_threshold=True)
    want = jmetrics.compute_eer(scores, labels, return_threshold=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for kw in ({}, {"p_target": 0.05, "c_miss": 2.0, "normalize": False}):
        assert abs(tmetrics.compute_min_dcf(scores, labels, **kw)
                   - jmetrics.compute_min_dcf(scores, labels, **kw)) <= 1e-12
    assert tmetrics.average_precision(labels, scores) == pytest.approx(
        jmetrics.average_precision(labels, scores), abs=1e-12)
    logits = np.random.default_rng(4).standard_normal((50, 7))
    targets = np.random.default_rng(5).integers(0, 7, 50)
    assert tmetrics.accuracy(logits, targets, (1, 3)) == jmetrics.accuracy(
        logits, targets, (1, 3))


def test_degenerate_eer_is_the_best_balanced_point():
    eer, thr = tmetrics.compute_eer([0.1, 0.2, 0.8, 0.9], [0, 0, 1, 1],
                                    return_threshold=True)
    assert eer == 0.0 and thr == pytest.approx(0.2)
    with pytest.raises(ValueError):
        tmetrics.compute_eer(fnr=np.zeros(2), fpr=np.zeros(2),
                             return_threshold=True)


def _stores(tmp_path):
    """The same embeddings as npz, ark, scp, an ark directory and an npy
    directory."""
    embs = _embeddings(6)
    first, rest = dict(list(embs.items())[:5]), dict(list(embs.items())[5:])
    os.makedirs(tmp_path / "npz_dir")
    tscoring.save_embeddings(str(tmp_path / "npz_dir" / "embeddings_0.npz"),
                             first)
    tscoring.save_embeddings(str(tmp_path / "npz_dir" / "embeddings_1.npz"),
                             rest)
    os.makedirs(tmp_path / "ark_dir")
    tark.write_ark_scp(str(tmp_path / "ark_dir" / "embedding_0.ark"), embs,
                       str(tmp_path / "ark_dir" / "embedding_0.scp"))
    os.makedirs(tmp_path / "npy_dir")
    for k, v in embs.items():
        np.save(tmp_path / "npy_dir" / f"{k}.npy", v)
    return embs, [str(tmp_path / p) for p in (
        "npz_dir", "npz_dir/embeddings_0.npz", "ark_dir",
        "ark_dir/embedding_0.ark", "ark_dir/embedding_0.scp", "npy_dir")]


def test_load_embeddings_equals_jax(tmp_path):
    embs, stores = _stores(tmp_path)
    for path in stores:
        got, want = tscoring.load_embeddings(path), jscoring.load_embeddings(
            path)
        assert sorted(got) == sorted(want), path
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], embs[k])
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        tscoring.load_embeddings(str(tmp_path / "empty"))


def _trials(path, embs, seed=7, n=60):
    rng = np.random.default_rng(seed)
    keys = sorted(embs)
    with open(path, "w") as f:
        for _ in range(n):
            a, b = rng.choice(keys, 2)
            f.write(f"{a} {b} {rng.choice(['1', '0', 'target', 'nontarget'])}\n")
        f.write("\n")


def test_load_trials_and_score_trials_equal_jax(tmp_path):
    embs = _embeddings(8)
    _trials(tmp_path / "trials", embs)
    trials = tscoring.load_trials(str(tmp_path / "trials"))
    assert trials == jscoring.load_trials(str(tmp_path / "trials"))
    got = tscoring.score_trials(embs, embs, trials, device="cpu")
    want = jscoring.score_trials(embs, embs, trials)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with open(tmp_path / "bad", "w") as f:
        f.write("a b maybe\n")
    with pytest.raises(ValueError):
        tscoring.load_trials(str(tmp_path / "bad"))


def test_pairwise_cosine_on_the_cpu_equals_jax():
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((37, 24)).astype(np.float32)
    emb[3] = 0.0  # a zero row: the 1e-12 floor of the norm
    got = tscoring.pairwise_cosine_device(emb, device="cpu")
    want = np.asarray(jscoring.pairwise_cosine_device(emb))
    assert got.shape == (37, 37) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a mesh of one process (no process group) gives the same product
    one = mesh.make_mesh(device="cpu")
    np.testing.assert_array_equal(
        tscoring.pairwise_cosine_device(emb, mesh=one), got)


@pytest.mark.parametrize("store", ["npz_dir", "ark_dir/embedding_0.scp",
                                   "npy_dir"])
def test_compute_score_metrics_bytes_equal_jax(tmp_path, store):
    embs, _ = _stores(tmp_path)
    _trials(tmp_path / "trials_a", embs, seed=10)
    _trials(tmp_path / "trials_b", embs, seed=11, n=25)
    data = str(tmp_path / store)
    common = ["--enrol_data", data, "--test_data", data, "--trials",
              str(tmp_path / "trials_a"), str(tmp_path / "trials_b")]
    jscore_cli.main(common + ["--scores_dir", str(tmp_path / "jax")])
    tscore_cli.main(common + ["--scores_dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    for name in ("trials_a.score", "trials_b.score", "result.metrics"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_process_rank_and_wav_scp(tmp_path, monkeypatch):
    for var in ("SPEAKER3D_PROC_INDEX", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.process_rank() == 0
    monkeypatch.setenv("RANK", "3")
    assert mesh.process_rank() == 3
    monkeypatch.setenv("SPEAKER3D_PROC_INDEX", "1")
    assert mesh.process_rank() == 1
    with open(tmp_path / "wav.scp", "w") as f:
        f.write("a /x/a.wav\n\nb /x/b c.wav\n")
    got = tfileio.load_wav_scp(str(tmp_path / "wav.scp"))
    assert got == jfileio.load_wav_scp(str(tmp_path / "wav.scp"))
    assert got == {"a": "/x/a.wav", "b": "/x/b c.wav"}
