"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and nvcc and skips without them. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets JAX up.)
"""

import numpy as np
import pytest
import torch

from speaker3d_tpu_torch.eval.embedding import build_embedding_fn, matmul_precision
from speaker3d_tpu_torch.models.eres2netv2 import BasicBlockERes2NetV2, ERes2NetV2
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk
from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk
from speaker3d_tpu_torch.tools import probe_ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _randomize(module, seed):
    """Seeded weights and BN statistics that keep activations alive."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var") or (name.endswith(".weight")
                                                and t.ndim == 1):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean") or name.endswith(".bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            else:
                t.copy_(torch.randn(t.shape, generator=gen)
                        * (2 / t[0].numel()) ** 0.5)
    return module.eval()


# 48,000 and 120,000: pad lengths of the diarization path on a long file
@pytest.mark.parametrize("n", [400, 24000, 48000, 48123, 120000])
def test_fbank_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    wav = torch.from_numpy((rng.standard_normal((5, n)) * 0.1)
                           .astype(np.float32)).to(cuda)
    fb = KaldiFbank(FbankConfig(), device=cuda)
    kw = dict(frame_length=400, frame_shift=160)
    launches = fk.fbank_features.launches
    with matmul_precision("float32"):
        got = fk.fbank_features(wav, fb._B, fb._mel, fb._packed, **kw)
        want = fk.fbank_plain(wav, fb._B, fb._mel, **kw)
    torch.cuda.synchronize()
    assert fk.fbank_features.launches == launches + 1
    assert got.shape == want.shape == (5, 1 + (n - 400) // 160, 80)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _oracle_ok(got, want) -> bool:
    """The Kaldi-oracle thresholds of tests/test_fbank_ref_oracle.py."""
    diff = (got - want).abs()
    strong = want > want.amax(dim=-1, keepdim=True) - 8.0
    return bool(diff[strong].max() < 5e-4 and diff.max() < 2e-2
                and diff.mean() < 1e-3)


# the path's batches (on 132 SMs the launch picks blocks of 5, 10 and 12
# m-tiles there, the 5 with two warps each), one file alone, a ragged last
# tile, and blocks of 8 m-tiles x 2 warps (132 rows of 256 frames)
@pytest.mark.parametrize("batch,n", [(64, 24000), (64, 48000), (64, 120000),
                                     (1, 48000), (1, 960000), (3, 41000),
                                     (132, 41200)])
def test_fbank_kernel_at_the_path_batches(cuda, batch, n):
    rng = np.random.default_rng(batch + n)
    wav = torch.from_numpy((rng.standard_normal((batch, n)) * 0.1)
                           .astype(np.float32)).to(cuda)
    fb = KaldiFbank(FbankConfig(), device=cuda)
    kw = dict(frame_length=400, frame_shift=160)
    with matmul_precision("float32"):
        got = fk.fbank_cuda(wav, fb._packed, **kw)
        want = fk.fbank_plain(wav, fb._B, fb._mel, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _oracle_ok(got, want)


# the windows K1 takes besides 16 kHz (8 kHz: 200-sample frames at stride
# 80, 128 bins; 48 kHz: 1200 at 480, 1024 bins) at their 10 s chunk, and
# the mel widths of the other backbones (M = 64: 8 n-tiles, not a multiple
# of MEL_NG = 5; M = 40)
@pytest.mark.parametrize("rate,mels,batch,n", [
    (8000, 80, 64, 80000), (48000, 80, 64, 480000), (16000, 64, 64, 160000),
    (16000, 40, 3, 41000), (8000, 80, 1, 33333), (48000, 64, 2, 100000)])
def test_fbank_kernel_other_windows_and_mel_widths(cuda, rate, mels, batch, n):
    rng = np.random.default_rng(rate + mels + n)
    wav = torch.from_numpy((rng.standard_normal((batch, n)) * 0.1)
                           .astype(np.float32)).to(cuda)
    cfg = FbankConfig(sample_rate=rate, num_mel_bins=mels)
    fb = KaldiFbank(cfg, device=cuda)
    kw = dict(frame_length=cfg.frame_length, frame_shift=cfg.frame_shift)
    launches = fk.fbank_features.launches
    with matmul_precision("float32"):
        got = fk.fbank_features(wav, fb._B, fb._mel, fb._packed, **kw)
        want = fk.fbank_plain(wav, fb._B, fb._mel, **kw)
    torch.cuda.synchronize()
    assert fk.fbank_features.launches == launches + 1
    assert got.shape == want.shape == (
        batch, 1 + (n - cfg.frame_length) // cfg.frame_shift, mels)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _oracle_ok(got, want)


@pytest.mark.parametrize("kw", [{"round_to_power_of_two": False},
                                {"sample_rate": 96000},
                                {"num_mel_bins": 96}])
def test_kaldi_fbank_on_the_card_refuses_what_k1_cannot_take(cuda, kw):
    with pytest.raises(ValueError, match="power-of-two|at most 80"):
        KaldiFbank(FbankConfig(**kw), device=cuda)


@pytest.mark.parametrize("use_power,use_log", [(False, True), (True, False)])
def test_fbank_kernel_options_match_plain(cuda, use_power, use_log):
    wav = torch.from_numpy((np.random.default_rng(7).standard_normal((4, 24000))
                            * 0.1).astype(np.float32)).to(cuda)
    fb = KaldiFbank(FbankConfig(), device=cuda)
    kw = dict(frame_length=400, frame_shift=160, use_power=use_power,
              use_log=use_log)
    with matmul_precision("float32"):
        got = fk.fbank_cuda(wav, fb._packed, **kw)
        want = fk.fbank_plain(wav, fb._B, fb._mel, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fbank_kernel_needs_the_packed_operands(cuda):
    fb = KaldiFbank(FbankConfig(), device=cuda)
    wav = torch.zeros((1, 4000), device=cuda)
    launches = fk.fbank_features.launches
    with pytest.raises(ValueError):
        fk.fbank_features(wav, fb._B, fb._mel, None, frame_length=400,
                          frame_shift=160)
    with pytest.raises(ValueError):  # packed for another frame length
        fk.fbank_cuda(wav, fb._packed, frame_length=480, frame_shift=160)
    assert fk.fbank_features.launches == launches


@pytest.mark.parametrize("cin,planes,stride,f,t", [
    (16, 16, 1, 21, 37),    # shortcut conv, ragged tiles
    (16, 16, 2, 21, 37),    # stride 2 read in the kernel
    (32, 16, 1, 8, 16),     # identity shortcut, one exact tile
    (64, 64, 1, 80, 50),    # the 17.8M model's layer1 widths (w = 26)
    (128, 128, 2, 80, 50),  # its layer2 entry (w = 52)
    (64, 64, 1, 80, 298),   # layer1 at 3 s chunks (L = 48,000)
    (128, 128, 2, 80, 748),  # layer2 entry at 7.5 s (L = 120,000)
    (256, 128, 1, 40, 149),  # layer2 after the stride at 3 s chunks
    (36, 36, 1, 13, 29),    # Cin and w = 14 not multiples of 8, Cout 72
    (64, 64, 1, 80, 998),   # layer1 at 10 s SV chunks (L = 160,000)
    (128, 64, 1, 80, 998),  # layer1.1
    (128, 128, 2, 80, 998),  # layer2 entry
    (256, 128, 1, 40, 499),  # layer2 after the stride
    (64, 64, 1, 80, 1237),  # a whole utterance at batch 1 (ragged T)
])
def test_res2_kernel_matches_plain(cuda, cin, planes, stride, f, t):
    blk = _randomize(BasicBlockERes2NetV2(cin, planes, stride=stride), cin + f)
    blk.to(cuda)
    folded = blk.folded()
    x = torch.rand((3, cin, f, t), generator=torch.Generator().manual_seed(t)
                   ).to(cuda)
    launches = rk.res2_block.launches
    with matmul_precision("float32"):
        got = rk.res2_block(x, folded, stride)
        want = rk.res2_block_plain(x, folded, stride)
    torch.cuda.synchronize()
    assert rk.res2_block.launches == launches + 1
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    # 3xTF32 keeps fp32-level error; one TF32 pass would be ~4e-3 off
    assert float((got - want).abs().max()) <= 1e-4


# ERes2Net's scale-2 blocks at F = 80, (Cin, planes, stride, F, T): base and
# VOX (w = 16 / 32, Cout 64 / 128) and large (w = 32 / 64, Cout 128 / 256;
# its layer2 takes the 8 x 16 tile, the only one whose shared memory fits)
ERES2NET_BLOCKS = {
    "base": [(32, 32, 1, 80), (64, 32, 1, 80), (64, 64, 2, 80),
             (128, 64, 1, 40)],
    "large": [(64, 64, 1, 80), (128, 64, 1, 80), (128, 128, 2, 80),
              (256, 128, 1, 40)],
}


@pytest.mark.parametrize("geom", sorted(ERES2NET_BLOCKS))
@pytest.mark.parametrize("frames", [149, 998])
def test_res2_kernel_at_eres2net_widths(cuda, geom, frames):
    for cin, planes, stride, f in ERES2NET_BLOCKS[geom]:
        t = frames if f == 80 else (frames + 1) // 2
        blk = _randomize(BasicBlockERes2NetV2(cin, planes, stride=stride,
                                              base_width=32), cin + t)
        blk.to(cuda)
        folded = blk.folded()
        x = torch.rand((2, cin, f, t), generator=torch.Generator()
                       .manual_seed(t)).to(cuda)
        launches = rk.res2_block.launches
        with matmul_precision("float32"):
            got = rk.res2_block(x, folded, stride)
            want = rk.res2_block_plain(x, folded, stride)
        torch.cuda.synchronize()
        assert rk.res2_block.launches == launches + 1
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
        assert float((got - want).abs().max()) <= 1e-4, (cin, planes, stride)


def test_eres2net_large_embed_batch_on_the_card(cuda):
    from speaker3d_tpu_torch.models.eres2net import eres2net_large

    model = _randomize(eres2net_large(embedding_size=512), 5)
    embed = build_embedding_fn(model, device=cuda, precision="high")
    wavs = torch.from_numpy((np.random.default_rng(6).standard_normal(
        (4, 48000)) * 0.1).astype(np.float32))
    k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
    out = embed(wavs)
    torch.cuda.synchronize()
    assert fk.fbank_features.launches == k1 + 1
    assert rk.res2_block.launches == k2 + 7  # layer1 (3) + layer2 (4)
    cpu = build_embedding_fn(model, device="cpu", precision="high")(wavs)
    cos = torch.nn.functional.cosine_similarity(out.cpu(), cpu, dim=1)
    assert out.shape == (4, 512) and float(cos.min()) >= 0.9999


def test_server_answers_a_request_on_the_card(cuda):
    import threading

    from speaker3d_tpu_torch.eval.chunking import embed_mean_over_plan, plan_chunks
    from speaker3d_tpu_torch.serve import request_embedding, serve

    model = _randomize(ERes2NetV2(num_blocks=(2, 2, 1, 1), m_channels=16), 7)
    embed = build_embedding_fn(model, device=cuda, precision="high")
    ready, holder = threading.Event(), []
    thread = threading.Thread(target=serve, args=(embed,), kwargs=dict(
        port=0, batch_size=4, ready_event=ready, server_holder=holder),
        daemon=True)
    thread.start()
    assert ready.wait(timeout=60)
    try:
        wav = (0.1 * np.random.default_rng(8).standard_normal(23 * 16000)
               ).astype(np.float32)
        k1 = fk.fbank_features.launches
        got = request_embedding(holder[0].server_address, pcm=wav)
        assert fk.fbank_features.launches > k1
    finally:
        holder[0].shutdown()
        thread.join(timeout=30)
    cpu = build_embedding_fn(model, device="cpu", precision="high")
    want = embed_mean_over_plan(cpu, wav, plan_chunks(len(wav), [160000],
                                                      90 * 16000))
    cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos >= 0.9999, cos


def test_res2_kernel_refuses_a_shape_no_tile_takes(cuda):
    # planes 160: w = 65 > 64 and Cout 320 > 256
    blk = _randomize(BasicBlockERes2NetV2(64, 160), 0).to(cuda)
    launches = rk.res2_block.launches
    with pytest.raises(RuntimeError, match="s3d_res2_block_f32"):
        rk.res2_block(torch.rand((1, 64, 8, 8), device=cuda), blk.folded())
    assert rk.res2_block.launches == launches


def test_embed_call_launches_both_kernels(cuda):
    model = _randomize(ERes2NetV2(num_blocks=(2, 2, 1, 1), m_channels=16), 0)
    embed = build_embedding_fn(model, device=cuda, precision="high")
    wavs = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (4, 24000)) * 0.1).astype(np.float32))
    k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
    out = embed(wavs)
    torch.cuda.synchronize()
    assert fk.fbank_features.launches == k1 + 1
    assert rk.res2_block.launches == k2 + 4  # layer1 (2) + layer2 (2)
    assert out.device.type == "cuda" and bool(torch.isfinite(out).all())
    cpu = build_embedding_fn(model, device="cpu", precision="high")(wavs)
    torch.testing.assert_close(out.cpu(), cpu, rtol=1e-3, atol=1e-3)


def test_embed_call_at_batch_1_and_a_ragged_length(cuda):
    """The exact-mode and infer_sv call: one whole utterance, any length."""
    model = _randomize(ERes2NetV2(num_blocks=(2, 2, 1, 1), m_channels=16), 1)
    embed = build_embedding_fn(model, device=cuda, precision="highest")
    wav = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (1, 77777)) * 0.1).astype(np.float32))
    k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
    out = embed(wav)
    torch.cuda.synchronize()
    assert fk.fbank_features.launches == k1 + 1
    assert rk.res2_block.launches == k2 + 4
    cpu = build_embedding_fn(model, device="cpu", precision="highest")(wav)
    torch.testing.assert_close(out.cpu(), cpu, rtol=1e-3, atol=1e-3)


def test_extract_cli_on_the_card_launches_both_kernels(cuda, tmp_path,
                                                       monkeypatch):
    from speaker3d_tpu_torch.cli import extract, registry
    from speaker3d_tpu_torch.eval.scoring import load_embeddings
    from speaker3d_tpu_torch.utils.fileio import write_wav

    model_id = "iic/speech_eres2netv2_sv_zh-cn_16k-common"
    small = dict(num_blocks=(2, 2, 1, 1), m_channels=16, embedding_size=32)
    for key, val in small.items():
        monkeypatch.setitem(registry.SUPPORTS[model_id]["model"]["args"], key,
                            val)
    ckpt = tmp_path / "pretrained" / model_id / registry.SUPPORTS[model_id][
        "model_pt"]
    ckpt.parent.mkdir(parents=True)
    torch.save(_randomize(registry.build_model(model_id), 3).state_dict(), ckpt)
    rng = np.random.default_rng(4)
    with open(tmp_path / "wav.scp", "w") as f:
        for utt, sec in (("a", 0.01), ("b", 1.7), ("c", 23.4)):
            write_wav(str(tmp_path / f"{utt}.wav"),
                      0.1 * rng.standard_normal(int(sec * 16000)), 16000)
            f.write(f"{utt} {tmp_path / utt}.wav\n")
    common = ["--model_id", model_id, "--local_model_dir",
              str(tmp_path / "pretrained"), "--data", str(tmp_path / "wav.scp")]
    embs = {}
    for mode in ("chunked", "exact"):
        k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
        extract.main(common + ["--mode", mode, "--out_dir",
                               str(tmp_path / mode)])
        torch.cuda.synchronize()
        d1, d2 = fk.fbank_features.launches - k1, rk.res2_block.launches - k2
        assert d1 > 0 and d2 == 4 * d1, (mode, d1, d2)
        embs[mode] = load_embeddings(str(tmp_path / mode))
        assert all(np.isfinite(v).all() for v in embs[mode].values())
    assert sorted(embs["chunked"]) == ["a", "b", "c"]
    assert sorted(embs["exact"]) == ["b", "c"]  # "a" is shorter than a frame


def test_device_nnchain_matches_host(cuda):
    from speaker3d_tpu_torch.diar.ahc_nnchain import (
        device_linkage_labels, linkage_labels)

    rng = np.random.default_rng(1)
    centers = rng.standard_normal((6, 64))
    x = (centers[rng.integers(0, 6, 400)]
         + 0.1 * rng.standard_normal((400, 64))).astype(np.float32)
    part = lambda lab: sorted(tuple(np.flatnonzero(lab == g)) for g in set(lab))
    assert part(device_linkage_labels(x, 0.4, device=cuda)) == part(
        linkage_labels(x, 0.4))


def _speakers(n, seed=2, n_spk=8, d=64, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_spk, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(0, n_spk, n)
    return (centers[lab] + spread * rng.standard_normal((n, d))).astype(
        np.float32), lab


def _part(labels):
    return sorted(tuple(np.flatnonzero(np.asarray(labels) == g))
                  for g in set(np.asarray(labels).tolist()))


@pytest.mark.parametrize("n,eigh_max_n", [(600, 2048), (600, 0)])
def test_spectral_device_path_matches_host_on_the_card(cuda, n, eigh_max_n):
    """The dense eigh branch and the LOBPCG branch (n > 5k) on the card
    give the host float64 path's partition."""
    from speaker3d_tpu_torch.diar.cluster import SpectralCluster

    x, lab = _speakers(n)
    kw = dict(pval=0.02, random_state=0, device=cuda)
    dev = SpectralCluster(backend="device", eigh_max_n=eigh_max_n, **kw)(x)
    host = SpectralCluster(backend="numpy", **kw)(x)
    assert _part(dev) == _part(host) == _part(lab)


def test_umap_layout_on_the_card(cuda):
    """The layout on the card keeps the speakers apart, and UMAP+HDBSCAN
    (native) recovers them."""
    from speaker3d_tpu_torch.diar.cluster import UmapHdbscan
    from speaker3d_tpu_torch.diar.umap_native import umap_embed

    x, lab = _speakers(400)
    y = umap_embed(x, n_neighbors=15, n_components=4, min_dist=0.0,
                   n_epochs=200, seed=0, device=cuda)
    assert y.shape == (400, 4) and np.isfinite(y).all()
    means = np.stack([y[lab == g].mean(0) for g in range(8)])
    spread = max(np.linalg.norm(y[lab == g] - means[g], axis=1).mean()
                 for g in range(8))
    gaps = np.linalg.norm(means[:, None] - means[None], axis=-1)
    assert gaps[~np.eye(8, dtype=bool)].min() > 2.0 * spread
    got = UmapHdbscan(n_neighbors=15, n_components=8, min_samples=10,
                      min_cluster_size=10, backend="native", device=cuda)(x)
    assert _part(got) == _part(lab)


@pytest.mark.parametrize("name", ["resnet", "res2net", "xvector"])
def test_recipe_backbone_batch_through_the_fbank_kernel(cuda, name):
    """ResNet34, Res2Net and x-vector at their recipe widths (80 mel bins):
    one batch through the embed call (K1, then a cuDNN trunk) against the
    plain functions on the CPU."""
    from speaker3d_tpu_torch.models.res2net import Res2Net
    from speaker3d_tpu_torch.models.resnet import ResNet
    from speaker3d_tpu_torch.models.xvector import Xvector

    model = {"resnet": lambda: ResNet(feat_dim=80, embedding_size=192,
                                      m_channels=32, two_emb_layer=False),
             "res2net": lambda: Res2Net(feat_dim=80, embedding_size=192,
                                        m_channels=32),
             "xvector": lambda: Xvector(feat_dim=80, embed_dim=512)}[name]()
    model = _randomize(model, 7)
    wavs = torch.from_numpy((np.random.default_rng(8).standard_normal(
        (4, 48000)) * 0.1).astype(np.float32))
    embed = build_embedding_fn(model, device=cuda, precision="high")
    k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
    out = embed(wavs)
    torch.cuda.synchronize()
    assert fk.fbank_features.launches == k1 + 1
    assert rk.res2_block.launches == k2
    cpu = build_embedding_fn(model, device="cpu", precision="high")(wavs)
    cos = torch.nn.functional.cosine_similarity(out.cpu(), cpu, dim=1)
    assert torch.isfinite(out).all() and float(cos.min()) >= 0.9999


@pytest.mark.parametrize("key", list("abcde"))
def test_probe_kernel_matches_plain(cuda, key):
    probe = probe_ops.PROBES[key]
    args = probe.args(probe_ops.make_inputs(cuda, seed=3))
    launches = probe.run.launches
    got = probe.run(*args)
    want = probe.plain(*args)
    torch.cuda.synchronize()
    assert probe.run.launches == launches + 1
    assert got.is_cuda and probe_ops.within_tolerance(key, got, want)


def test_probe_all_matches_plain_in_one_launch(cuda):
    inputs = probe_ops.make_inputs(cuda, seed=3)
    launches = probe_ops.probe_all.launches
    per_probe = {k: p.run.launches for k, p in probe_ops.PROBES.items()}
    outs = probe_ops.probe_all(inputs["x"], inputs["w9"], inputs["w2"])
    torch.cuda.synchronize()
    assert probe_ops.probe_all.launches == launches + 1
    assert per_probe == {k: p.run.launches for k, p in probe_ops.PROBES.items()}
    for key, probe in probe_ops.PROBES.items():
        want = probe.plain(*probe.args(inputs))
        assert outs[key].is_cuda and probe_ops.within_tolerance(key, outs[key], want)


@pytest.mark.parametrize("f,t,w", [(4, 50, 24), (4, 70, 26)])
def test_probe_all_refuses_a_shape_without_a_launch(cuda, f, t, w):
    x = torch.zeros((f, t, w), dtype=torch.bfloat16, device=cuda)
    w9 = torch.zeros((9 * w, w), dtype=torch.bfloat16, device=cuda)
    w2 = torch.zeros((w, 2 * w), dtype=torch.bfloat16, device=cuda)
    launches = probe_ops.probe_all.launches
    with pytest.raises(RuntimeError, match="s3d_probe_all"):
        probe_ops.probe_all(x, w9, w2)
    assert probe_ops.probe_all.launches == launches


def test_probe_tool_runs_one_fused_launch(cuda, capsys):
    run = probe_ops.ToolRun()
    launches = probe_ops.probe_all.launches
    assert probe_ops.main([], run) == 0
    # one checked launch, then the timed ones
    assert probe_ops.probe_all.launches > launches
    assert run.ms is not None and run.ms > 0
    assert [r.probe.key for r in run.results] == list("abcde")
    assert all(not r.error for r in run.results)
    probe_ops.empty_launch()
    torch.cuda.synchronize()
