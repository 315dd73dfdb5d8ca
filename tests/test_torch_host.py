"""The PyTorch package's own copies of the host-side modules (diar/vad.py,
utils/wire.py, utils/fileio.py) give exactly the JAX package's results."""

import numpy as np
import pytest

from speaker3d_tpu.diar import vad as jvad
from speaker3d_tpu.utils import fileio as jio
from speaker3d_tpu.utils import wire as jwire
from speaker3d_tpu_torch.diar import vad as tvad
from speaker3d_tpu_torch.utils import fileio as tio
from speaker3d_tpu_torch.utils import wire as twire
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000


def _tone(n, freq=300.0):
    return np.sin(2 * np.pi * freq * np.arange(n) / FS).astype(np.float32)


def _vad_inputs():
    """The audio of tests/test_vad.py plus a seeded speech/pause mix."""
    rng = np.random.default_rng(0)
    sil = rng.standard_normal(FS) * 0.001
    speech = np.sin(2 * np.pi * 200 * np.arange(FS) / FS) * 0.3
    yield np.concatenate([sil, speech, sil]).astype(np.float32)
    wav = np.zeros(FS, np.float32)
    wav[1600:2400] = 0.5 * _tone(800)
    wav[3200:12800] = 0.5 * _tone(9600)
    yield wav
    wav2 = np.zeros(FS, np.float32)
    wav2[3200:12800] = 0.5 * _tone(9600)
    yield wav2
    rng = np.random.default_rng(4)
    parts = []
    for _ in range(12):
        parts.append(np.zeros(int(rng.uniform(0.05, 0.6) * FS), np.float32))
        parts.append((rng.uniform(0.05, 0.4) * _tone(int(rng.uniform(0.1, 2.0) * FS),
                                                     rng.uniform(100, 900))))
    yield np.concatenate(parts) + (0.002 * rng.standard_normal(
        sum(map(len, parts)))).astype(np.float32)


def test_vad_chain_equal():
    assert tvad.try_ten_vad() is None and jvad.try_ten_vad() is None
    for wav in _vad_inputs():
        tf, tw = tvad.EnergyVAD(FS)(wav)
        jf, jw = jvad.EnergyVAD(FS)(wav)
        assert tf == jf
        np.testing.assert_array_equal(tw, jw)
        tp = tvad.post_process_speech_flags(tf)
        np.testing.assert_array_equal(tp, jvad.post_process_speech_flags(jf))
        tm = tvad.flags_to_mask(tp, len(wav), 256)
        np.testing.assert_array_equal(tm, jvad.flags_to_mask(tp, len(wav), 256))
        np.testing.assert_array_equal(tvad.frame_energy_envelope(wav, FS),
                                      jvad.frame_energy_envelope(wav, FS))
        for thr in (0.001, 0.05):
            tr = tvad.refine_vad_boundaries_with_energy(wav, tm, FS, thr)
            jr = jvad.refine_vad_boundaries_with_energy(wav, tm, FS, thr)
            np.testing.assert_array_equal(tr, jr)
            assert tvad.mask_to_intervals(tr, FS) == jvad.mask_to_intervals(jr, FS)
        assert (tvad.flags_to_intervals(tf, len(wav), 256, FS)
                == jvad.flags_to_intervals(jf, len(wav), 256, FS))


def test_refinement_quirk_pinned():
    """tests/test_vad.py's energy-refinement contract holds in the port."""
    mask = np.zeros(FS, np.float32)
    mask[1600:14400] = 1
    _, wav, wav2 = list(_vad_inputs())[:3]
    refined = tvad.refine_vad_boundaries_with_energy(wav, mask, FS,
                                                     energy_threshold=0.001)
    assert tvad.mask_to_intervals(refined, FS) == [[0.1, 0.9]]
    refined2 = tvad.refine_vad_boundaries_with_energy(wav2, mask, FS,
                                                      energy_threshold=0.001)
    assert abs(tvad.mask_to_intervals(refined2, FS)[0][0] - 0.1) < 0.01


def test_post_process_and_percentile_fuzz_equal():
    rng = np.random.default_rng(42)
    for _ in range(30):
        n = int(rng.integers(1, 400))
        flags = (rng.random(n) < rng.random()).astype(np.float32)
        np.testing.assert_array_equal(tvad.post_process_speech_flags(flags),
                                      jvad.post_process_speech_flags(flags))
    audio = (rng.standard_normal(20000) * 0.1).astype(np.float32)
    env = tvad.frame_energy_envelope(audio, FS)
    ends_last = ((20000 - 320) // 160) * 160 + 320
    for _ in range(50):
        s = int(rng.integers(0, 19000))
        e = int(rng.integers(s + 1, 20000))
        p = float(rng.choice([0.0, 10.0, 50.0, 100.0]))
        assert (tvad._sorted_env_percentile(env, s, e, ends_last, p)
                == jvad._sorted_env_percentile(env, s, e, ends_last, p))
    assert tvad.merge_vad([[0, 1], [2, 3]], [[0.5, 2.5]]) == [[0, 3]]
    assert (tvad.merge_vad([[0, 1], [4, 5]], [[0.5, 2.5]])
            == jvad.merge_vad([[0, 1], [4, 5]], [[0.5, 2.5]]))


def test_wire_quantize_equal():
    rng = np.random.default_rng(1)
    pcm = (rng.integers(-32768, 32768, size=100000).astype(np.float32)
           / 32768.0)
    q = twire.wire_quantize(pcm)
    assert q.dtype == np.int16
    np.testing.assert_array_equal(q, jwire.wire_quantize(pcm))
    np.testing.assert_array_equal(q.astype(np.float32) / 32768.0, pcm)
    floats = (rng.standard_normal(1000) * 0.1).astype(np.float32)
    assert twire.wire_quantize(floats) is None
    assert twire.wire_quantize(np.zeros(0, np.float32)) is None
    loud = pcm.copy()
    loud[0] = np.float32(40000.0 / 32768.0)
    assert twire.wire_quantize(loud) is None


@pytest.mark.parametrize("rate", [16000, 8000, 44100])
def test_wav_roundtrip_and_load_audio_equal(tmp_path, rate):
    rng = np.random.default_rng(2)
    stereo = (rng.standard_normal((2, rate // 2)) * 0.2).astype(np.float32)
    path = str(tmp_path / "a.wav")
    tio.write_wav(path, stereo, rate)
    jpath = str(tmp_path / "b.wav")
    jio.write_wav(jpath, stereo, rate)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    tw, tr = tio.read_wav(path)
    jw, jr = jio.read_wav(path)
    assert tr == jr == rate
    np.testing.assert_array_equal(tw, jw)
    # PCM16 round trip: the truncated sample k, decoded as k/32768 exactly
    np.testing.assert_array_equal(
        tw, np.trunc(np.clip(stereo * 32768, -32768, 32767)) / 32768)
    # resampling: scipy here, the JAX package's native C++ where built; the
    # two agree within float32 reassociation (tests/test_host_resample.py)
    np.testing.assert_allclose(tio.load_audio(path, obj_fs=16000),
                               jio.load_audio(path, obj_fs=16000),
                               rtol=0, atol=2e-6)


def test_load_audio_arrays_equal():
    rng = np.random.default_rng(3)
    i16 = rng.integers(-3000, 3000, size=4000).astype(np.int16)
    np.testing.assert_array_equal(tio.load_audio(i16), jio.load_audio(i16))
    two = rng.standard_normal((4000, 2)).astype(np.float32)
    np.testing.assert_array_equal(tio.load_audio(two), jio.load_audio(two))
    np.testing.assert_allclose(tio.load_audio(two[:, 0], 48000, 16000),
                               jio.load_audio(two[:, 0], 48000, 16000),
                               rtol=0, atol=2e-6)
    with pytest.raises(ValueError):
        tio.load_audio(np.zeros((2, 2, 2), np.float32))
