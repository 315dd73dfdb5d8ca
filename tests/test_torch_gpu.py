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
# tile, blocks of 8 m-tiles x 2 warps (132 rows of 256 frames), and the
# trainer's batch of 3 s crops (configs/eres2netv2.yaml)
@pytest.mark.parametrize("batch,n", [(64, 24000), (64, 48000), (64, 120000),
                                     (1, 48000), (1, 960000), (3, 41000),
                                     (132, 41200), (256, 48000)])
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


# bf16 K2 against its plain bf16 version: both round to bf16 at the same
# points and sum in fp32 in their own orders, so an element near a rounding
# boundary may round the other way: at most 1% of the elements differ, none
# by more than two bf16 ulps (2^-7) of the output's scale
BF16_DIFF_SHARE = 0.01
BF16_MAX_ULPS = 2.0


def assert_bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    share = float((got != want).float().mean())
    ulps = float((got - want).abs().max()) / (float(want.abs().max()) * 2.0 ** -8)
    assert share <= BF16_DIFF_SHARE and ulps <= BF16_MAX_ULPS, (share, ulps)


# (Cin, planes, stride, F, T, base_width): the 17.8M model's layer1 and
# layer2 entry at 3 s chunks, an identity-shortcut block with ragged tiles,
# ERes2Net large's layer2 (w = 64, Cout = 256)
@pytest.mark.parametrize("cin,planes,stride,f,t,bw", [
    (64, 64, 1, 80, 298, 26), (128, 128, 2, 80, 298, 26),
    (256, 128, 1, 40, 37, 26), (256, 128, 1, 40, 149, 32)])
def test_res2_kernel_bf16_matches_plain(cuda, cin, planes, stride, f, t, bw):
    blk = _randomize(BasicBlockERes2NetV2(cin, planes, stride=stride,
                                          base_width=bw), cin + t)
    blk.to(cuda)
    folded = blk.folded(torch.bfloat16)
    x = torch.rand((3, cin, f, t), generator=torch.Generator().manual_seed(t)
                   ).to(cuda).bfloat16()
    launches = (rk.res2_block.launches, rk.res2_block.launches_bf16)
    with matmul_precision("float32"):
        got = rk.res2_block(x, folded, stride)
        want = rk.res2_block_plain(x, folded, stride)
    torch.cuda.synchronize()
    assert (rk.res2_block.launches, rk.res2_block.launches_bf16) == (
        launches[0], launches[1] + 1)
    assert_bf16_close(got, want)


def test_res2_kernel_refuses_other_dtypes_on_the_card(cuda):
    blk = _randomize(BasicBlockERes2NetV2(64, 64), 0).to(cuda)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            rk.res2_block(torch.rand((1, 64, 8, 8), device=cuda, dtype=dtype),
                          blk.folded(torch.bfloat16))


def test_bf16_embed_call_on_the_card_matches_the_cpu(cuda):
    """build_embedding_fn(dtype=bfloat16): K1 in fp32, K2's bf16 variant
    (never the fp32 one), the embedding against the CPU's bf16 path."""
    model = _randomize(ERes2NetV2(num_blocks=(2, 2, 1, 1), m_channels=16), 0)
    wavs = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (4, 48000)) * 0.1).astype(np.float32))
    cpu = build_embedding_fn(model, device="cpu", dtype=torch.bfloat16)(wavs)
    embed = build_embedding_fn(model, device=cuda, dtype=torch.bfloat16)
    k = (fk.fbank_features.launches, rk.res2_block.launches,
         rk.res2_block.launches_bf16)
    out = embed(wavs)
    torch.cuda.synchronize()
    assert (fk.fbank_features.launches, rk.res2_block.launches,
            rk.res2_block.launches_bf16) == (k[0] + 1, k[1], k[2] + 4)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    cos = torch.nn.functional.cosine_similarity(out.cpu(), cpu, dim=1)
    assert float(cos.min()) >= 0.999, cos


def test_int8_apply_on_the_card_matches_the_cpu(cuda):
    """eval/quant.py: scales calibrated on the card equal the CPU's; the int8
    apply launches no K2 and agrees with the CPU's int8 apply."""
    from speaker3d_tpu_torch.eval.quant import (
        calibrate_act_scales, quantized_apply_fn)

    model = _randomize(ERes2NetV2(num_blocks=(2, 2, 1, 1), m_channels=16), 3)
    feats = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 150, 80)).astype(np.float32))
    cpu_scales = calibrate_act_scales(model, feats)
    scales = calibrate_act_scales(model.to(cuda), feats.to(cuda))
    assert scales.keys() == cpu_scales.keys()
    for key, v in scales.items():
        assert abs(v - cpu_scales[key]) <= 1e-3 * cpu_scales[key], key
    k2 = (rk.res2_block.launches, rk.res2_block.launches_bf16)
    got = quantized_apply_fn(model, cpu_scales)(feats.to(cuda))
    torch.cuda.synchronize()
    assert (rk.res2_block.launches, rk.res2_block.launches_bf16) == k2
    want = quantized_apply_fn(model.cpu(), cpu_scales)(feats)
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(),
                                                want.float(), dim=1)
    assert float(cos.min()) >= 0.999, cos


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


# the trainer on the card: configs/eres2netv2.yaml's 17.8M ERes2NetV2 at
# full width, one SGD step on 16 seeded 3 s crops
TRAIN_ARGS = dict(feat_dim=80, embedding_size=192, base_width=26, scale=2,
                  expansion=2)


def _train_step_on_the_card(cuda, feature_fn, remat,
                            compute_dtype="float32"):
    from speaker3d_tpu_torch.train import sv_train

    torch.manual_seed(3)
    model = ERes2NetV2(**TRAIN_ARGS)
    cfg = sv_train.SVTrainConfig(num_classes=24, remat=remat,
                                 step_per_epoch=10,
                                 compute_dtype=compute_dtype)
    state = sv_train.init_sv_train_state(model, cfg, seed=3, device=cuda)
    step = sv_train.make_sv_train_step(model, cfg, feature_fn=feature_fn)
    rng = np.random.default_rng(3)
    batch = {"wavs": torch.from_numpy(
        np.clip(np.rint(rng.standard_normal((16, 48000)) * 3000), -32768,
                32767).astype(np.int16)).to(cuda),
             "labels": torch.from_numpy(rng.integers(0, 24, 16)).to(cuda)}
    launches = fk.fbank_features.launches
    metrics = step(state, batch)
    torch.cuda.synchronize()
    return (float(metrics["loss"]), state.model.state_dict(),
            fk.fbank_features.launches - launches)


def _plain_fbank(fb):
    def feats(wav):
        out = fk.fbank_plain(wav, fb._B, fb._mel, frame_length=400,
                             frame_shift=160)
        return out - out.mean(dim=-2, keepdim=True)
    return feats


def test_train_step_through_k1_matches_the_plain_fbank(cuda):
    """K1 runs inside a step with autograd on (its input needs no
    gradient); the step through it against the same step through the plain
    fbank: loss to rtol 1e-3, parameters to 1e-3 (conv1's gradient sums
    the two fbanks' weak-bin differences, which the Kaldi oracle allows up
    to 2e-2: 1.8e-4 measured at lr 1e-4 on the H100)."""
    fb = KaldiFbank(FbankConfig(), mean_norm=True, device=cuda)
    k_loss, k_sd, k_n = _train_step_on_the_card(cuda, fb, False)
    p_loss, p_sd, p_n = _train_step_on_the_card(cuda, _plain_fbank(fb), False)
    assert (k_n, p_n) == (1, 0)
    assert np.isfinite(k_loss)
    assert k_loss == pytest.approx(p_loss, rel=1e-3)
    for name, p in ERes2NetV2(**TRAIN_ARGS).named_parameters():
        torch.testing.assert_close(k_sd[name], p_sd[name], rtol=0, atol=1e-3)
    for k in k_sd:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(k_sd[k], p_sd[k], rtol=1e-4, atol=1e-5)


def test_train_step_with_remat_equals_without_on_the_card(cuda):
    fb = KaldiFbank(FbankConfig(), mean_norm=True, device=cuda)
    loss, sd, _ = _train_step_on_the_card(cuda, fb, False)
    r_loss, r_sd, _ = _train_step_on_the_card(cuda, fb, True)
    assert r_loss == pytest.approx(loss, rel=1e-5, abs=1e-5)
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(r_sd[k], sd[k], rtol=1e-5, atol=1e-5)
    assert int(r_sd["layer1.0.bn1.num_batches_tracked"]) == 1


def test_bf16_train_step_against_the_fp32_step_on_the_card(cuda):
    """One bf16 step of the 17.8M model (cuDNN's bf16 convolutions, K1 in
    fp32 before the cast) against its fp32 step from the same state and
    batch: one K1 launch, fp32 masters and statistics, the loss within 5%,
    the embedding layer's update at cosine >= 0.9 with the fp32 step's
    (0.993 on the CPU). The early layers' gradients cross the whole bf16
    trunk backwards and decorrelate on these random weights (the CPU: conv1
    0.03; the H100: median over tensors ~0), so they are not held."""
    fb = KaldiFbank(FbankConfig(), mean_norm=True, device=cuda)
    loss, sd, _ = _train_step_on_the_card(cuda, fb, False)
    h_loss, h_sd, h_n = _train_step_on_the_card(cuda, fb, False, "bfloat16")
    assert h_n == 1 and np.isfinite(h_loss)
    assert h_loss == pytest.approx(loss, rel=0.05)
    assert all(v.dtype in (torch.float32, torch.int64) for v in h_sd.values())
    torch.manual_seed(3)
    start = ERes2NetV2(**TRAIN_ARGS).state_dict()["seg_1.weight"].to(cuda)
    u = (h_sd["seg_1.weight"] - start).flatten().double()
    w = (sd["seg_1.weight"] - start).flatten().double()
    assert float(u @ w / (u.norm() * w.norm())) >= 0.9


def test_bn_bf16_input_on_the_card(cuda):
    """A bf16 step's BatchNorm call on the card (bf16 input, the bf16 casts
    of the weights taken up to fp32, fp32 statistics): a bf16 output within
    one bf16 step of the fp32 normalisation of the same values, the running
    statistics as Flax's update of the bf16 input, in float64, to 1e-6."""
    from speaker3d_tpu_torch.models.common import batch_norm2d
    from speaker3d_tpu_torch.train.sv_train import bf16_parameters

    torch.manual_seed(0)
    layer = batch_norm2d(32).to(cuda).train()
    with torch.no_grad():
        layer.weight.uniform_(0.5, 1.5)
        layer.bias.normal_(0.0, 0.1)
    x = (torch.randn(16, 32, 40, 75, device=cuda) * 2.5 + 0.7).bfloat16()
    want_mean = 0.99 * layer.running_mean.double() + 0.01 * x.double().mean(
        (0, 2, 3))
    want_var = 0.99 * layer.running_var.double() + 0.01 * x.double().var(
        (0, 2, 3), unbiased=False)
    ref = torch.nn.functional.batch_norm(
        x.float(), None, None, layer.weight.bfloat16().float(),
        layer.bias.bfloat16().float(), True, 0.0, layer.eps).detach()
    with bf16_parameters(layer):
        out = layer(x)
    assert out.dtype == torch.bfloat16
    assert layer.running_mean.dtype == layer.running_var.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=2.0 ** -8 * float(ref.abs().max()))
    torch.testing.assert_close(layer.running_mean.double(), want_mean,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(layer.running_var.double(), want_var,
                               rtol=0, atol=1e-6)


def test_device_prefetch_copies_batches_to_the_card(cuda):
    from speaker3d_tpu_torch.data.prefetch import device_prefetch

    rng = np.random.default_rng(0)
    batches = [{"wavs": rng.integers(-9, 9, (8, 4000)).astype(np.int16),
                "labels": np.arange(8, dtype=np.int32) + i} for i in range(7)]
    out = []
    for b in device_prefetch(iter(batches), cuda, depth=2):
        assert all(t.is_cuda for t in b.values())
        out.append({k: v.clone() for k, v in b.items()})
        torch.cuda._sleep(1_000_000)  # the consumer's stream stays busy
    torch.cuda.synchronize()
    assert len(out) == 7
    for got, want in zip(out, batches):
        for k in want:
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])


@pytest.mark.parametrize("kind,shape", [("2d", (16, 32, 40, 75)),
                                        ("1d", (16, 32, 50)), ("1d", (64, 32))])
def test_bn_training_statistics_on_the_card(cuda, kind, shape):
    """cuDNN's training-mode BatchNorm inside the port's layers: Flax's
    update (momentum 0.99, biased variance), computed here in float64."""
    from speaker3d_tpu_torch.models.common import batch_norm1d, batch_norm2d

    torch.manual_seed(0)
    layer = (batch_norm2d if kind == "2d" else batch_norm1d)(shape[1]).to(cuda)
    layer.train()
    want_mean = layer.running_mean.double().clone()
    want_var = layer.running_var.double().clone()
    dims = [d for d in range(len(shape)) if d != 1]
    for _ in range(3):
        x = (torch.randn(shape, device=cuda) * 2.5 + 0.7)
        out = layer(x)
        xd = x.double()
        want_mean = 0.99 * want_mean + 0.01 * xd.mean(dims)
        want_var = 0.99 * want_var + 0.01 * xd.var(dims, unbiased=False)
        ref = torch.nn.functional.batch_norm(x, None, None, layer.weight,
                                             layer.bias, True, 0.0, layer.eps)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(layer.running_mean.double(), want_mean,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(layer.running_var.double(), want_var,
                               rtol=0, atol=1e-6)



def test_fsmn_front_ends_run_k1_on_the_card(cuda):
    """DnnVAD and DnnSegmenter at their configs' widths on seeded weights:
    one K1 launch per batch of windows; probabilities through K1 within
    1e-3 of the plain fbank's on the card and of the CPU's."""
    import copy

    from speaker3d_tpu_torch.diar.dnn_seg import DnnSegmenter
    from speaker3d_tpu_torch.diar.dnn_vad import DnnVAD
    from speaker3d_tpu_torch.models.fsmn_vad import FSMNVad, lecun_init_
    from speaker3d_tpu_torch.models.segmentation import FSMNSegmenter

    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal(16000 * 13)).astype(np.float32)
    # 13 s: 3 VAD chunks of 512 frames (one batch of 4), 17 segmenter
    # windows (3 batches of 8)
    for front_cls, model_cls, batches in ((DnnVAD, FSMNVad, 1),
                                          (DnnSegmenter, FSMNSegmenter, 3)):
        model = lecun_init_(model_cls(), torch.Generator().manual_seed(1))
        fronts = {d: front_cls(copy.deepcopy(model), device=d)
                  for d in ("cpu", cuda)}

        def probs(front):
            return (front.frame_probs(wav)[0] if front_cls is DnnVAD
                    else front(wav).data)

        on_cpu = probs(fronts["cpu"])
        front = fronts[cuda]
        launches = fk.fbank_features.launches
        got = probs(front)
        assert fk.fbank_features.launches - launches == batches
        fb = front.fbank
        front.fbank = lambda w: fk.fbank_plain(
            w, fb._B, fb._mel, frame_length=400, frame_shift=160)
        plain = probs(front)
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-3)
        np.testing.assert_allclose(got, on_cpu, rtol=0, atol=1e-3)


# transcription and predict_label: configs/asr_ctc.yaml's width (d_model
# 256, 6 layers, LFR 5/4) on 8 seeded 6 s tone crops
ASR_ARGS = dict(feat_dim=80, d_model=256, num_heads=4, ffn_dim=1024,
                num_layers=6, kernel_size=11, lfr_m=5, lfr_n=4)


def _asr_batch(rng, b=8, n=96000, u=5, vocab=3):
    t = np.arange(n) / 16000
    f0 = rng.uniform(300, 1800, (b, 1))
    wav = (0.3 * np.sin(2 * np.pi * f0 * t)
           * (np.sin(2 * np.pi * rng.uniform(1, 3, (b, 1)) * t) > 0)
           + 0.01 * rng.standard_normal((b, n))).astype(np.float32)
    lens = rng.integers(1, u + 1, b).astype(np.int32)
    labels = np.zeros((b, u), np.int32)
    for i, k in enumerate(lens):
        labels[i, :k] = rng.integers(1, vocab + 1, k)
    return {"wavs": torch.from_numpy(wav), "labels": torch.from_numpy(labels),
            "label_lens": torch.from_numpy(lens)}


def test_ctc_train_step_on_the_card_matches_the_cpu_plain_step(cuda):
    """One Adam step of the CTC model at the shipped width from one state
    and batch: on the card through K1 (one launch) against the CPU's step
    through the plain fbank: loss to rtol 1e-3, parameters to 1e-3, first
    moments (the gradients / 10) to 1e-2 of each tensor's largest entry,
    but the key third of each linear_q_k_v bias, whose gradient is zero but
    for rounding (the softmax removes a constant over the keys)."""
    import copy

    from speaker3d_tpu_torch.asr import ctc
    from speaker3d_tpu_torch.train import vad_train

    base = ctc.init_sanm_ctc_(ctc.SANMCTC(vocab_size=3, **ASR_ARGS),
                              torch.Generator().manual_seed(0))
    batch = _asr_batch(np.random.default_rng(0))
    out = {}
    for dev in ("cpu", cuda):
        fb = KaldiFbank(FbankConfig(), mean_norm=False, device=dev)
        state = vad_train.init_adam_train_state(copy.deepcopy(base), dev)
        step = ctc.make_ctc_train_step(ctc.CTCTrainConfig(step_per_epoch=10),
                                       lambda w, fb=fb: fb(w) / 4.0 - 2.0)
        launches = fk.fbank_features.launches
        metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (float(metrics["loss"]),
                         {k: v.cpu() for k, v in state.model.state_dict().items()},
                         {k: v.cpu() for k, v in state.adam_m.items()},
                         fk.fbank_features.launches - launches)
    (c_loss, c_sd, c_m, c_n), (g_loss, g_sd, g_m, g_n) = out["cpu"], out["cuda"]
    assert (c_n, g_n) == (0, 1)
    assert np.isfinite(g_loss) and g_loss == pytest.approx(c_loss, rel=1e-3)
    for k in c_sd:
        torch.testing.assert_close(g_sd[k], c_sd[k], rtol=0, atol=1e-3)
    d = ASR_ARGS["d_model"]
    for k in c_m:
        a, b = g_m[k], c_m[k]
        if k.endswith("linear_q_k_v.bias"):
            a, b = (torch.cat([x[:d], x[2 * d:]]) for x in (a, b))
        assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max()), k


def _asr_exp(root, vocab=("bip", "bop", "beep")):
    """A transcriber's experiment on seeded weights (the blank prior off,
    so the argmax varies): config.yaml, vocab.json, cmvn.npy, models/."""
    import json
    import os

    import yaml

    from speaker3d_tpu_torch.asr import ctc
    from speaker3d_tpu_torch.train import vad_train
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer

    model = ctc.init_sanm_ctc_(ctc.SANMCTC(vocab_size=len(vocab), **ASR_ARGS),
                               torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.ctc_out.bias.zero_()
    os.makedirs(root)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump({"sample_rate": 16000, "wav_len": 6.0,
                        "model": {"args": ASR_ARGS}}, f)
    with open(os.path.join(root, "vocab.json"), "w") as f:
        json.dump(list(vocab), f)
    np.save(os.path.join(root, "cmvn.npy"),
            np.stack([np.full(80, -8.0), np.full(80, 4.0)]).astype(np.float32))
    state = vad_train.init_adam_train_state(model, "cpu")
    Checkpointer(os.path.join(root, "models")).save_checkpoint(
        1, {"train_state": vad_train.state_tree(state)})
    return root


def test_transcriber_through_k1_matches_the_plain_fbank(cuda, tmp_path):
    """A 9 s recording in two 6 s windows (one K1 launch each) through the
    transcriber on the card: the same tokens and timestamps as through the
    plain fbank on the card and as on the CPU, logits within 1e-4."""
    from speaker3d_tpu_torch.asr.ctc import CTCTranscriber

    exp = _asr_exp(str(tmp_path / "exp"))
    wav = _asr_batch(np.random.default_rng(2), b=1, n=9 * 16000)["wavs"][0]
    wav = wav.numpy()
    tr = CTCTranscriber(exp, device=cuda)
    launches = fk.fbank_features.launches
    got = tr.transcribe(wav)
    assert fk.fbank_features.launches - launches == 2
    logits = tr.logits(wav[:96000]).cpu().numpy()
    fb = tr.fbank
    tr.fbank = lambda w: fk.fbank_plain(w, fb._B, fb._mel, frame_length=400,
                                        frame_shift=160)
    assert tr.transcribe(wav) == got
    np.testing.assert_allclose(tr.logits(wav[:96000]).cpu().numpy(), logits,
                               rtol=0, atol=1e-4)
    on_cpu = CTCTranscriber(exp, device="cpu")
    assert on_cpu.transcribe(wav) == got and got["timestamp"]
    np.testing.assert_allclose(on_cpu.logits(wav[:96000]).numpy(), logits,
                               rtol=0, atol=1e-4)


def test_predict_label_on_the_card_matches_the_cpu(cuda, tmp_path, capsys):
    """predict_label on an experiment of the 17.8M ERes2NetV2 (seeded
    weights, 4 classes): one K1 and seven K2 launches per wav on the card,
    the same predictions file and accuracy line as on the CPU (the plain
    functions)."""
    import os

    import yaml

    from speaker3d_tpu_torch.cli import predict_label
    from speaker3d_tpu_torch.data.processors import SpkLabelEncoder
    from speaker3d_tpu_torch.train import sv_train
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
    from speaker3d_tpu_torch.utils.fileio import write_wav

    exp = tmp_path / "exp"
    os.makedirs(exp)
    model = _randomize(ERes2NetV2(**TRAIN_ARGS), 4)
    cfg = sv_train.SVTrainConfig(num_classes=4, embedding_size=192)
    state = sv_train.init_sv_train_state(model, cfg, seed=4, device="cpu")
    Checkpointer(str(exp / "models")).save_checkpoint(
        1, {"train_state": sv_train.state_tree(state)})
    with open(exp / "config.yaml", "w") as f:
        yaml.safe_dump({"model": {
            "obj": "speaker3d_tpu.models.eres2netv2.ERes2NetV2",
            "args": TRAIN_ARGS}}, f)
    enc = SpkLabelEncoder()
    for lab in ("en", "zh", "fr", "de"):
        enc.add(lab)
    enc.save(str(exp / "label_encoder.pkl"))
    rng = np.random.default_rng(5)
    with open(tmp_path / "wav.scp", "w") as scp, \
            open(tmp_path / "utt2lang", "w") as u2l:
        for i in range(6):
            path = str(tmp_path / f"u{i}.wav")
            t = np.arange(int(rng.uniform(1.0, 4.0) * 16000)) / 16000
            write_wav(path, (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400)
                                          * t)
                             + 0.05 * rng.standard_normal(len(t))), 16000)
            scp.write(f"u{i} {path}\n")
            u2l.write(f"u{i} {('en', 'zh', 'fr', 'de')[i % 4]}\n")
    outs = {}
    for dev in ("cpu", "cuda"):
        k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
        capsys.readouterr()
        predict_label.main(["--exp_dir", str(exp), "--data",
                            str(tmp_path / "wav.scp"), "--utt2label",
                            str(tmp_path / "utt2lang"), "--out",
                            str(tmp_path / f"{dev}.txt"), "--device", dev])
        torch.cuda.synchronize()
        line = capsys.readouterr().out.splitlines()[-1]
        outs[dev] = (line, (tmp_path / f"{dev}.txt").read_bytes(),
                     fk.fbank_features.launches - k1,
                     rk.res2_block.launches - k2)
    assert outs["cpu"][2:] == (0, 0) and outs["cuda"][2:] == (6, 42)
    assert outs["cuda"][:2] == outs["cpu"][:2]
    assert outs["cuda"][0].startswith("accuracy: ")


def _melspec_f64(wav):
    """The SSL mel spectrogram in float64 numpy."""
    from speaker3d_tpu_torch.ops.melspec import (
        MelSpecConfig, mel_filterbank, window_dft_matrix)

    cfg = MelSpecConfig()
    p = cfg.n_fft // 2
    x = np.pad(wav.astype(np.float64), ((0, 0), (p, p)), mode="reflect")
    n = 1 + (x.shape[1] - cfg.n_fft) // cfg.hop_length
    idx = np.arange(n)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)
    y = x[:, idx] @ window_dft_matrix(cfg)
    bins = cfg.n_fft // 2 + 1
    return (y[..., :bins] ** 2 + y[..., bins:] ** 2) @ mel_filterbank(cfg)


@pytest.mark.parametrize("shape", [(16, 64000), (32, 32000)])
def test_melspec_on_the_card_matches_float64(cuda, shape):
    """The SSL feature in fp32 with TF32 off: within 1e-5 of max|want|."""
    from speaker3d_tpu_torch.ops.melspec import MelSpectrogram

    wav = (0.1 * np.random.default_rng(shape[0]).standard_normal(shape)
           ).astype(np.float32)
    got = MelSpectrogram(device=cuda)(torch.from_numpy(wav).to(cuda))
    want = _melspec_f64(wav)
    assert np.abs(got.cpu().numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("variant", ["rdino", "sdpn"])
def test_ssl_step_on_the_card_matches_the_cpu_step(cuda, variant):
    """One SSL step from one state and batch (ECAPA 64 x 4, 192, B = 4):
    loss within 1e-3 relative, parameters within 1e-3 of the largest
    parameter magnitude, center / prototypes within 1e-3 of theirs (leaf by
    leaf the fp32 gradients of random ECAPA weights are ill-conditioned,
    tests/test_torch_ssl.py)."""
    import copy

    from speaker3d_tpu_torch.cli.train_ssl import (
        build_ssl_model, ssl_train_config)
    from speaker3d_tpu_torch.ops.melspec import MelSpectrogram
    from speaker3d_tpu_torch.train import ssl_train
    from speaker3d_tpu_torch.utils.checkpoint import _flatten

    config = {"channels": [64, 64, 64, 64, 192], "embedding_dim": 64,
              "out_dim": 256, "add_dim": 64, "bottleneck_dim": 32,
              "num_proto": 16, "output_dim": 32, "batch_size": 4,
              "lr": 0.2, "warmup_epochs": 1, "epochs": 4}
    model = build_ssl_model(variant, config, seed=3)
    cfg = ssl_train_config(config, variant, 2)
    rng = np.random.default_rng(4)
    g = 2 if variant == "rdino" else 1
    batch = {"global_wavs": torch.from_numpy((0.1 * rng.standard_normal(
                 (4, g, 32000))).astype(np.float32)),
             "local_wavs": torch.from_numpy((0.1 * rng.standard_normal(
                 (4, 4, 16000))).astype(np.float32))}
    out = {}
    for device in ("cpu", cuda):
        state = ssl_train.init_ssl_state(
            copy.deepcopy(model), cfg, variant, device,
            generator=torch.Generator().manual_seed(5))
        state.step = 3
        make = (ssl_train.make_rdino_train_step if variant == "rdino"
                else ssl_train.make_sdpn_train_step)
        step = make(cfg, feature_fn=MelSpectrogram(device=device))
        loss = float(step(state, {k: v.to(device) for k, v in batch.items()})
                     ["loss"])
        out[str(device)] = (loss, ssl_train.state_tree(state))
    (lc, cpu), (lg, card) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-3 * abs(lc)
    for part in ("student", "teacher"):
        want = dict(_flatten(cpu[part]["params"]))
        got = dict(_flatten(card[part]["params"]))
        scale = max(float(np.abs(v).max()) for v in want.values())
        for k, v in want.items():
            assert np.abs(got[k] - v).max() <= 1e-3 * scale, (part, k)
    for key in ("center", "prototypes"):
        if key in cpu:
            assert (np.abs(card[key] - cpu[key]).max()
                    <= 1e-3 * np.abs(cpu[key]).max())


@pytest.mark.parametrize("hw", [(288, 384), (43, 61)])
def test_face_detector_on_the_card_matches_the_cpu(cuda, hw):
    """The detector at configs/face_det.yaml's width, TF32 off, at the
    config's frame size and an odd one (the SAME padding)."""
    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.models.face_detector import TinyFaceDetector

    model = _randomize(TinyFaceDetector(channels=24), 21)
    x = torch.from_numpy(np.random.default_rng(22).random(
        (2,) + hw + (1,)).astype(np.float32))
    with torch.inference_mode(), matmul_precision("float32"):
        want = [t.numpy() for t in model(x)]
        got = [t.cpu().numpy() for t in model.to(cuda)(x.to(cuda))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_face_detector_train_step_on_the_card_matches_the_cpu(cuda):
    import copy

    from speaker3d_tpu_torch.cli import train_face_detector as tfd_cli
    from speaker3d_tpu_torch.train.vad_train import (
        init_adam_train_state, state_tree)

    config = {"height": 96, "width": 128, "batch_size": 6,
              "step_per_epoch": 4, "num_epoch": 2,
              "model": {"args": {"channels": 24}}}
    model = tfd_cli.init_model(config, 3)
    batch = tfd_cli.make_batch_fn(config)(np.random.default_rng(4))
    out = {}
    for device in ("cpu", cuda):
        state = init_adam_train_state(copy.deepcopy(model), device)
        step = tfd_cli.make_detector_train_step(tfd_cli.train_config(config))
        loss = float(step(state, {k: torch.from_numpy(v).to(device)
                                  for k, v in batch.items()})["loss"])
        out[str(device)] = (loss, state_tree(state))
    (lc, cpu), (lg, card) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for coll in ("params", "batch_stats", "adam_m"):
        for name, leaves in cpu[coll].items():
            for leaf, v in leaves.items():
                g = card[coll][name][leaf]
                assert np.abs(g - v).max() <= 1e-3 * np.abs(v).max(), (
                    coll, name, leaf)


def test_talknet_on_the_card_matches_the_cpu(cuda):
    """TalkNet's three heads at B = 2, T = 25 (the depth-axis 3-D
    convolution crosses the two clips), TF32 off; the ASD scorer likewise."""
    import copy

    from speaker3d_tpu_torch.diar.video import make_talknet_asd_scorer
    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.models.talknet import TalkNetModel

    torch.manual_seed(23)
    model = _randomize(TalkNetModel(), 24)
    rng = np.random.default_rng(25)
    audio = torch.from_numpy(rng.standard_normal((2, 100, 13)).astype(
        np.float32))
    faces = torch.from_numpy((rng.random((2, 25, 112, 112)) * 255).astype(
        np.float32))
    with torch.inference_mode(), matmul_precision("float32"):
        want = [t.numpy() for t in model(audio, faces)]
        card = copy.deepcopy(model).to(cuda)
        got = [t.cpu().numpy() for t in card(audio.to(cuda), faces.to(cuda))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    sd = model.state_dict()
    a, f = audio[0].numpy(), faces[0].numpy()
    np.testing.assert_allclose(
        make_talknet_asd_scorer(sd, device=cuda)(a, f),
        make_talknet_asd_scorer(sd, device="cpu")(a, f), rtol=0, atol=1e-5)


# the entries whose gradient is zero but for rounding (a bias before a
# training-mode BatchNorm; the key third of each attention's in_proj_bias)
ASD_HELD_APART = "visualConv1D.net.0.bias"


def asd_step_comparison(cpu_sd, cpu_m, card_sd, card_m):
    """The card's TalkNet step against the CPU's: the BatchNorm statistics'
    worst leaf of its scale, and the first moments' (the gradients') median
    and worst leaf of their scale and the held-apart entries' largest first
    moment, on both sides."""
    stats = [np.abs(card_sd[k] - v).max() / max(np.abs(v).max(), 1e-12)
             for k, v in cpu_sd.items() if "running_" in k]
    ratios, held = [], 0.0
    for k, v in cpu_m.items():
        g = card_m[k]
        if k == ASD_HELD_APART:
            held = max(held, np.abs(v).max(), np.abs(g).max())
            continue
        if k.endswith("in_proj_bias"):
            d = v.shape[0] // 3
            held = max(held, np.abs(v[d:2 * d]).max(),
                       np.abs(g[d:2 * d]).max())
            v, g = np.r_[v[:d], v[2 * d:]], np.r_[g[:d], g[2 * d:]]
        ratios.append(np.abs(g - v).max() / max(np.abs(v).max(), 1e-12))
    return {"stats_worst": float(max(stats)),
            "grad_median": float(np.median(ratios)),
            "grad_worst": float(max(ratios)), "held_apart_max": float(held)}


def test_asd_train_step_on_the_card_matches_the_cpu(cuda):
    """One TalkNet step (cli/train_asd.py's) at B = 2, T = 25 from the same
    seeded init and batch: the loss, the BatchNorm statistics and the first
    moments. The random TalkNet's fp32 gradients are ill-conditioned leaf
    by leaf (tests/test_torch_asd_train.py): the port's own fp32 CPU step
    lies a median 4e-5 and at worst 6e-2 of a leaf's scale from its
    float64 step; the held-apart entries' moments are ~1e-10."""
    import copy

    from speaker3d_tpu_torch.train import asd_train
    from speaker3d_tpu_torch.train.vad_train import init_adam_train_state

    rng = np.random.default_rng(25)
    batch = {"audio": rng.standard_normal((2, 100, 13)).astype(np.float32),
             "visual": (rng.random((2, 25, 112, 112)) * 255).astype(
                 np.float32),
             "labels": rng.integers(0, 2, (2, 25)).astype(np.int32)}
    model = asd_train.init_talknet(3)
    out = {}
    for device in ("cpu", cuda):
        state = init_adam_train_state(copy.deepcopy(model), device)
        step = asd_train.make_asd_train_step(
            asd_train.ASDTrainConfig(step_per_epoch=4))
        m = step(state, {k: torch.from_numpy(v).to(device)
                         for k, v in batch.items()})
        out[str(device)] = (
            m["loss"].item(), m["scores"].cpu().numpy(),
            {k: v.cpu().numpy() for k, v in state.model.state_dict().items()},
            {k: v.cpu().numpy() for k, v in state.adam_m.items()})
    (lc, sc, cpu_sd, cpu_m), (lg, sg, card_sd, card_m) = (out["cpu"],
                                                          out["cuda"])
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    np.testing.assert_allclose(sg, sc, rtol=0, atol=1e-5)
    cmp = asd_step_comparison(cpu_sd, cpu_m, card_sd, card_m)
    assert cmp["stats_worst"] <= 1e-4, cmp
    assert cmp["grad_median"] <= 1e-3 and cmp["grad_worst"] <= 0.25, cmp
    assert cmp["held_apart_max"] <= 1e-6, cmp


def test_diarization_driver_on_the_card_matches_the_cli(cuda, tmp_path,
                                                        capsys):
    """run_diarization_on_dir on the card over two seeded wavs with an
    experiment of the 17.8M ERes2NetV2's layout: the same JSON and
    .vad_info.json bytes as the diarization CLI's own run on the card, K1
    and K2 (7 x K1) launched; the summary of every file."""
    import json
    import os

    import yaml

    from speaker3d_tpu_torch.cli import infer_diarization, run_diarization_on_dir
    from speaker3d_tpu_torch.train import sv_train
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
    from speaker3d_tpu_torch.utils.fileio import write_wav

    exp = tmp_path / "exp"
    os.makedirs(exp)
    model = _randomize(ERes2NetV2(**TRAIN_ARGS), 4)
    cfg = sv_train.SVTrainConfig(num_classes=4, embedding_size=192)
    state = sv_train.init_sv_train_state(model, cfg, seed=4, device="cpu")
    Checkpointer(str(exp / "models")).save_checkpoint(
        1, {"train_state": sv_train.state_tree(state)})
    with open(exp / "config.yaml", "w") as f:
        yaml.safe_dump({"model": {
            "obj": "speaker3d_tpu.models.eres2netv2.ERes2NetV2",
            "args": TRAIN_ARGS}}, f)
    src = tmp_path / "src"
    os.makedirs(src)
    rng = np.random.default_rng(6)
    for i in range(2):
        t = np.arange(int(rng.uniform(6.0, 12.0) * 16000)) / 16000
        write_wav(str(src / f"c{i}_speech_estimate.wav"),
                  0.3 * np.sin(2 * np.pi * (150 + 200 * (t > t[-1] / 2)) * t)
                  * (np.sin(2 * np.pi * 0.5 * t) > -0.3), 16000)
    wavs = sorted(str(p) for p in src.iterdir())
    k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
    assert run_diarization_on_dir.main(
        ["--src_dir", str(src), "--out_dir", str(tmp_path / "drv"),
         "--summary_out", str(tmp_path / "summary.json"), "--exp_dir",
         str(exp), "--device", "cuda"]) == 0
    torch.cuda.synchronize()
    k1, k2 = fk.fbank_features.launches - k1, rk.res2_block.launches - k2
    assert k1 > 0 and k2 == 7 * k1
    infer_diarization.main(["--wav"] + wavs + [
        "--out_dir", str(tmp_path / "cli"), "--out_type", "json",
        "--sidecar", "--exp_dir", str(exp), "--device", "cuda"])
    for w in wavs:
        base = os.path.splitext(os.path.basename(w))[0]
        for ext in (".json", ".vad_info.json"):
            assert ((tmp_path / "drv" / (base + ext)).read_bytes()
                    == (tmp_path / "cli" / (base + ext)).read_bytes())
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert sorted(summary) == ["c0_speech_estimate", "c1_speech_estimate"]


def test_fbank_kernel_at_the_para_window_and_shape(cuda):
    """K1 with the Hamming window (train_para's frontend) at its train
    shape [256, 48000]: the window is folded into B, so the kernel is the
    same; against the plain version at rtol = atol = 1e-4 and the Kaldi
    oracle."""
    rng = np.random.default_rng(17)
    wav = torch.from_numpy((rng.standard_normal((256, 48000)) * 0.1)
                           .astype(np.float32)).to(cuda)
    cfg = FbankConfig(window_type="hamming")
    fb = KaldiFbank(cfg, device=cuda)
    kw = dict(frame_length=cfg.frame_length, frame_shift=cfg.frame_shift)
    launches = fk.fbank_features.launches
    with matmul_precision("float32"):
        got = fk.fbank_features(wav, fb._B, fb._mel, fb._packed, **kw)
        want = fk.fbank_plain(wav, fb._B, fb._mel, **kw)
    torch.cuda.synchronize()
    assert fk.fbank_features.launches == launches + 1
    assert got.shape == want.shape == (256, 298, 80)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _oracle_ok(got, want)


PARA_CONFIG = {"fbank_dim": 80, "lfr_m": 7, "lfr_n": 6, "wav_len": 3.0,
               "asr_encoder": {"args": {"d_model": 64, "num_heads": 4,
                                        "ffn_dim": 128, "num_layers": 2,
                                        "kernel_size": 11}}}


def test_para_step_on_the_card_matches_the_cpu(cuda):
    """One fused train_para step (the frozen frontend with K1 at the
    Hamming window as ``feature_fn``, a small ERes2Net on the encoder's
    output) on the card against the CPU's from one state: one K1 launch,
    the encoder unchanged, loss to rtol 1e-4, running statistics to 1e-4
    and parameters to 1e-5 (an lr-1e-4 step)."""
    import copy

    from speaker3d_tpu_torch.cli.train_para import build_frozen_frontend
    from speaker3d_tpu_torch.models.eres2net import ERes2Net
    from speaker3d_tpu_torch.train import sv_train

    torch.manual_seed(4)
    base = ERes2Net(num_blocks=(1, 1, 1, 1), m_channels=16, feat_dim=64)
    cfg = sv_train.SVTrainConfig(num_classes=8, step_per_epoch=10)
    rng = np.random.default_rng(4)
    batch = {"wavs": torch.from_numpy((rng.standard_normal((8, 48000))
                                       * 0.1).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 8, 8))}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        front = build_frozen_frontend(PARA_CONFIG, 7, dev)[0]
        enc0 = {k: v.clone() for k, v in front.encoder.state_dict().items()}
        model = copy.deepcopy(base)
        state = sv_train.init_sv_train_state(model, cfg, seed=4, device=dev)
        step = sv_train.make_sv_train_step(model, cfg, feature_fn=front)
        launches = fk.fbank_features.launches
        loss = float(step(state, {k: v.to(dev) for k, v in
                                  batch.items()})["loss"])
        for k, v in front.encoder.state_dict().items():
            assert torch.equal(v, enc0[k]), k
        out[dev.type] = (loss, {k: v.cpu() for k, v in
                                model.state_dict().items()},
                         fk.fbank_features.launches - launches)
    (lc, sc, nc), (lh, sh, nh) = out["cuda"], out["cpu"]
    assert (nc, nh) == (1, 0)
    assert np.isfinite(lc) and lc == pytest.approx(lh, rel=1e-4)
    for k, v in sh.items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(sc[k], v, rtol=1e-4, atol=1e-4)
        elif v.is_floating_point():
            torch.testing.assert_close(sc[k], v, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["eres2net", "campplus", "ecapa"])
def test_remat_equals_without_on_the_card(cuda, name):
    """Remat on every kind of backbone (per block, per dense layer, the
    whole forward) against the plain step from one state, through K1:
    loss and running statistics within 1e-5 (cuDNN's fp32 algorithms are
    not bit-deterministic), every ``num_batches_tracked`` 1."""
    from speaker3d_tpu_torch.models.campplus import CAMPPlus
    from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
    from speaker3d_tpu_torch.models.eres2net import ERes2Net
    from speaker3d_tpu_torch.train import sv_train

    build = {"eres2net": lambda: ERes2Net(num_blocks=(1, 1, 1, 1),
                                          m_channels=16),
             "campplus": lambda: CAMPPlus(embedding_size=192,
                                          growth_rate=16, bn_size=2,
                                          init_channels=32),
             "ecapa": lambda: ECAPA_TDNN(channels=(64, 64, 64, 64, 192),
                                         attention_channels=16,
                                         se_channels=16)}[name]
    fb = KaldiFbank(FbankConfig(), mean_norm=True, device=cuda)
    rng = np.random.default_rng(5)
    batch = {"wavs": torch.from_numpy((rng.standard_normal((16, 48000))
                                       * 0.1).astype(np.float32)).to(cuda),
             "labels": torch.from_numpy(rng.integers(0, 8, 16)).to(cuda)}
    out = []
    for remat in (False, True):
        torch.manual_seed(5)
        model = build()
        cfg = sv_train.SVTrainConfig(num_classes=8, step_per_epoch=10,
                                     remat=remat)
        state = sv_train.init_sv_train_state(model, cfg, seed=5, device=cuda)
        step = sv_train.make_sv_train_step(model, cfg, feature_fn=fb)
        out.append((float(step(state, batch)["loss"]), model.state_dict()))
    (loss, sd), (r_loss, r_sd) = out
    assert r_loss == pytest.approx(loss, rel=1e-5, abs=1e-5)
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(r_sd[k], v, rtol=1e-5, atol=1e-5)
        elif k.endswith("num_batches_tracked"):
            assert int(r_sd[k]) == int(v) == 1, k


SEMANTIC_WIDTH = dict(vocab_size=1000, hidden_size=256, num_hidden_layers=4,
                      num_attention_heads=4)


def semantic_batch(rng, token_level, b=8, n=64, vocab=1000):
    """Class-indicative ids (label-1 rows open with token 7), rows padded to
    n / 2 - n tokens, the first and last tokens' labels ignored."""
    y = rng.integers(0, 2, b)
    ids = rng.integers(10, vocab, (b, n))
    ids[y == 1, : n // 4] = 7
    mask = np.ones((b, n), np.int64)
    for i, length in enumerate(rng.integers(n // 2, n + 1, b)):
        mask[i, length:] = 0
        ids[i, length:] = 0
    if token_level:
        labels = (ids == 7).astype(np.int64)
        labels[:, 0] = labels[:, -1] = -100
    else:
        labels = y
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            (("input_ids", ids), ("attention_mask", mask),
             ("labels", labels))}


@pytest.mark.parametrize("task", ["sequence", "token"])
def test_semantic_bert_on_the_card_matches_the_cpu(cuda, task):
    """Both heads' logits on the card against the CPU from one seeded BERT,
    TF32 off: within 1e-4 of their scale."""
    from speaker3d_tpu_torch.semantic.bert import build_model

    batch = semantic_batch(np.random.default_rng(0), task == "token")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = build_model(task, seed=2, device=dev, **SEMANTIC_WIDTH)
        with torch.no_grad(), matmul_precision("float32", dev):
            out[dev.type] = model(batch["input_ids"].to(dev),
                                  batch["attention_mask"].to(dev)).cpu()
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-4 * scale


def semantic_step_diffs(card, cpu, held=".attention.self.key.bias"):
    """Gradients (first moments / (1 - b1) after one step) card against
    CPU: each leaf's max error over its largest entry, the median and the
    worst over the leaves but ``held``, whose gradient is zero but for
    rounding (a bias on the keys shifts each query's scores by one
    constant, which the softmax removes): the largest of those against the
    largest gradient of all."""
    errs, top = {}, max(float(g.abs().max()) for g in cpu.values())
    held_top = 0.0
    for k, g in cpu.items():
        if k.endswith(held):
            held_top = max(held_top, float(g.abs().max()),
                           float(card[k].abs().max()))
            continue
        scale = float(g.abs().max())
        if scale > 0:
            errs[k] = float((card[k] - g).abs().max()) / scale
    worst = max(errs, key=errs.get)
    return {"median": float(np.median(list(errs.values()))),
            "worst": errs[worst], "worst_leaf": worst,
            "held_of_top": held_top / top}


@pytest.mark.parametrize("task", ["sequence", "token"])
def test_semantic_train_step_on_the_card_matches_the_cpu(cuda, task):
    """One AdamW step on the card against the CPU's from one seeded BERT:
    loss to rtol 1e-5, gradients at a median 1e-4 and a worst leaf 1e-2 of
    their scale, the keys' biases' gradients rounding noise."""
    from speaker3d_tpu_torch.semantic.bert import (
        SemanticTrainConfig, build_model, make_semantic_train_step)
    from speaker3d_tpu_torch.train.vad_train import init_adam_train_state

    token_level = task == "token"
    batch = semantic_batch(np.random.default_rng(1), token_level)
    cfg = SemanticTrainConfig(lr=1e-4, total_steps=10)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = build_model(task, seed=3, device=dev, **SEMANTIC_WIDTH)
        state = init_adam_train_state(model, dev)
        step = make_semantic_train_step(model, cfg, token_level)
        loss = float(step(state, {k: v.to(dev) for k, v in batch.items()})
                     ["loss"])
        out[dev.type] = (loss, {k: (m / (1 - cfg.beta1)).cpu()
                                for k, m in state.adam_m.items()})
    assert np.isfinite(out["cuda"][0])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    d = semantic_step_diffs(out["cuda"][1], out["cpu"][1])
    assert d["median"] <= 1e-4 and d["worst"] <= 1e-2, d
    assert d["held_of_top"] <= 1e-5, d


def _plain_blocks(model, x):
    """``model(x)`` with every Res2 block through the plain version."""
    from speaker3d_tpu_torch.models import eres2netv2

    kernel, eres2netv2.res2_block = eres2netv2.res2_block, rk.res2_block_plain
    try:
        with torch.inference_mode(), matmul_precision("high"):
            return model(x)
    finally:
        eres2netv2.res2_block = kernel


def _export_case(cuda, seed):
    model = _randomize(ERes2NetV2(num_blocks=(2, 2, 1, 1), m_channels=16),
                       seed).to(cuda)
    gen = torch.Generator().manual_seed(seed)
    return model, lambda b, t: torch.randn((b, t, 80), generator=gen).to(cuda)


def test_res2_operator_through_an_exported_program_on_the_card(cuda,
                                                                tmp_path):
    """The dynamic-batch .pt2 traced on the card: its s3d::res2_block nodes
    launch K2 (4 a call at any batch), against the plain blocks."""
    from speaker3d_tpu_torch.cli import export_speaker_embedding as ex

    model, feats = _export_case(cuda, 3)
    blob, meta = ex.export_model(model, frames=200, device=cuda)
    assert meta["dynamic_batch"] and meta["device"] == "cuda"
    path = tmp_path / "m.pt2"
    path.write_bytes(blob)
    run = ex.load_exported(str(path))
    for batch in (1, 5):
        x = feats(batch, 200)
        k2 = rk.res2_block.launches
        got = run(x)
        torch.cuda.synchronize()
        assert rk.res2_block.launches == k2 + 4
        torch.testing.assert_close(got, _plain_blocks(model, x), rtol=1e-3,
                                   atol=1e-3)


def test_res2_operator_through_an_aoti_package_on_the_card(cuda, tmp_path):
    """An AOTInductor package compiled on the card, loaded in Python: the
    proxy executor calls s3d::res2_block, which launches K2. The package's
    cuDNN convolutions follow the process's TF32 flags (the native engine
    sets them from aot.json), so it runs with TF32 off."""
    from speaker3d_tpu_torch.cli import export_speaker_embedding as ex

    model, feats = _export_case(cuda, 4)
    meta = ex.export_aot_artifact(model, str(tmp_path), frames=150,
                                  device=cuda)
    assert meta["device"] == "cuda" and meta["frames"] == 150
    runner = torch._inductor.aoti_load_package(str(tmp_path / "model.pt2"))
    x = feats(1, 150)
    k2 = rk.res2_block.launches
    with torch.inference_mode(), matmul_precision("high"):
        got = runner(x)
    torch.cuda.synchronize()
    got = got[0] if isinstance(got, (list, tuple)) else got
    assert rk.res2_block.launches == k2 + 4
    torch.testing.assert_close(got, _plain_blocks(model, x), rtol=1e-3,
                               atol=1e-3)


@pytest.fixture
def nccl_world_1(cuda):
    """A process group of this process alone over NCCL (one card admits one
    NCCL rank), through ``init_multihost``; its 1 x 1 mesh."""
    import socket

    from speaker3d_tpu_torch.parallel import mesh as pm

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert pm.init_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield pm.make_mesh(device="cuda")
    finally:
        torch.distributed.destroy_process_group()


def test_world_1_mesh_train_step_equals_the_step_without_a_group(
        cuda, nccl_world_1):
    """The mesh step's collectives (the flat gradient sums, the loss and
    accuracy, the BatchNorm statistics' mean, the class shards) over one
    NCCL rank change nothing: two steps through K1 as without a mesh. Both
    runs take cuDNN's deterministic algorithms, so that a difference can
    come only from the mesh path: cuDNN's default weight gradients sum in
    a racy order, and two runs without a mesh differ."""
    from speaker3d_tpu_torch.train import sv_train

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        _world_1_step_matches(sv_train, nccl_world_1, cuda)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def _world_1_step_matches(sv_train, mesh_1, cuda):

    def run(mesh):
        torch.manual_seed(3)
        model = ERes2NetV2(**TRAIN_ARGS)
        cfg = sv_train.SVTrainConfig(num_classes=24, step_per_epoch=10,
                                     warmup_epoch=1)
        state = sv_train.init_sv_train_state(model, cfg, seed=3, device=cuda,
                                             mesh=mesh)
        step = sv_train.make_sv_train_step(
            model, cfg, mesh=mesh,
            feature_fn=KaldiFbank(FbankConfig(), mean_norm=True, device=cuda))
        rng = np.random.default_rng(3)
        launches = fk.fbank_features.launches
        metrics = []
        for _ in range(2):
            batch = {"wavs": torch.from_numpy(np.clip(np.rint(
                rng.standard_normal((16, 48000)) * 3000), -32768,
                32767).astype(np.int16)).to(cuda),
                "labels": torch.from_numpy(rng.integers(0, 24, 16)).to(cuda)}
            metrics.append({k: float(v) for k, v in
                            step(state, batch).items()})
        torch.cuda.synchronize()
        return (metrics, sv_train.state_tree(state),
                fk.fbank_features.launches - launches)

    want_m, want, want_n = run(None)
    got_m, got, got_n = run(mesh_1)
    assert got_n == want_n == 2
    for g, w in zip(got_m, want_m):
        assert g == pytest.approx(w, rel=1e-6, abs=1e-6)
    moved = 0.0
    for k, v in want["model"].items():
        np.testing.assert_allclose(got["model"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["cls_w"], want["cls_w"], rtol=0, atol=1e-5)
    for k, v in want["momentum"]["model"].items():
        moved = max(moved, float(np.abs(v).max()))
        np.testing.assert_allclose(got["momentum"]["model"][k], v, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(v).max())),
                                   err_msg=k)
    assert moved > 1e-3  # the steps computed gradients worth comparing


def test_world_1_sharded_embedding_launches_both_kernels(cuda, nccl_world_1):
    from speaker3d_tpu_torch.eval.embedding import build_sharded_embedding_fn

    model = _randomize(ERes2NetV2(num_blocks=(2, 2, 1, 1), m_channels=16), 0)
    wavs = torch.from_numpy((np.random.default_rng(4).standard_normal(
        (4, 24000)) * 0.1).astype(np.float32))
    want = build_embedding_fn(model, device=cuda, precision="high")(wavs)
    embed = build_sharded_embedding_fn(model, None, nccl_world_1,
                                       precision="high")
    k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
    got = embed(wavs)
    torch.cuda.synchronize()
    assert fk.fbank_features.launches == k1 + 1
    assert rk.res2_block.launches == k2 + 4
    assert got.device.type == "cuda" and got.shape == (4, 192)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_world_1_mesh_affinity_matches_the_product(cuda, nccl_world_1):
    from speaker3d_tpu_torch.eval.scoring import pairwise_cosine_device

    emb = np.random.default_rng(5).standard_normal((301, 192)).astype(
        np.float32)
    want = pairwise_cosine_device(emb, device=cuda)
    got = pairwise_cosine_device(emb, mesh=nccl_world_1)
    assert got.shape == (301, 301)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, pairwise_cosine_device(emb, device="cpu"), rtol=0, atol=1e-5)
