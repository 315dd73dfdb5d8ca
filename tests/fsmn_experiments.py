"""Tiny FSMN VAD / segmenter / x-vector experiments and an overlapping
conversation for the port's DNN front-end tests (tests/test_torch_dnn_*.py).

The sizes are those of tests/test_fsmn_vad.py and tests/test_segmentation.py:
three tone 'speakers' of three 2 s utterances, windows of 2 s, hidden 32,
proj 16, two layers."""

import os

import numpy as np
import yaml

FS = 16000
F0S = {"spkA": 180.0, "spkB": 420.0, "spkC": 900.0}
MODEL = {"feat_dim": 80, "hidden_dim": 32, "proj_dim": 16, "num_layers": 2,
         "lorder": 10}


def speech_like(rng, n, f0=220.0):
    """Harmonic tone with amplitude modulation, separable from noise."""
    t = np.arange(n) / FS
    sig = (np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(2 * np.pi * 2 * f0 * t)
           + 0.25 * np.sin(2 * np.pi * 3 * f0 * t))
    am = 0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)
    return (0.3 * am * sig + 0.005 * rng.standard_normal(n)).astype(np.float32)


def write_corpus(root):
    """train.csv (ID,wav,spk) of the three tone speakers; returns its path."""
    from speaker3d_tpu.utils.fileio import write_wav

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    rows = []
    for spk, f0 in F0S.items():
        for u in range(3):
            p = os.path.join(root, "wav", f"{spk}u{u}.wav")
            write_wav(p, speech_like(rng, 2 * FS, f0 * (1 + 0.03 * u)), FS)
            rows.append((f"{spk}u{u}", p, spk))
    csv = os.path.join(root, "train.csv")
    with open(csv, "w") as f:
        f.write("ID,wav,spk\n")
        for r in rows:
            f.write(",".join(r) + "\n")
    return csv


def _write(root, name, config):
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def vad_config(root, csv, name="vad", num_epoch=10, dataset_size=128):
    return _write(root, name, {
        "exp_dir": os.path.join(root, name), "speech": csv,
        "window_dur": 2.0, "dataset_size": dataset_size, "batch_size": 16,
        "num_workers": 2, "num_epoch": num_epoch, "max_lr": 0.005,
        "warmup_epoch": 1, "snr_range": [10.0, 25.0],
        "model": {"args": dict(MODEL, rorder=3)}})


def seg_config(root, csv, name="seg", num_epoch=12, dataset_size=128):
    return _write(root, name, {
        "exp_dir": os.path.join(root, name), "speech": csv,
        "window_dur": 2.0, "max_speakers": 2, "events_per_speaker": 1,
        "dataset_size": dataset_size, "batch_size": 16, "num_workers": 2,
        "num_epoch": num_epoch, "max_lr": 0.005, "warmup_epoch": 1,
        "snr_range": [10.0, 25.0],
        "model": {"args": dict(MODEL, rorder=10)}})


def sv_config(root, csv, name="sv"):
    """The tiny x-vector SV experiment of tests/test_segmentation.py."""
    return _write(root, name, {
        "exp_dir": os.path.join(root, name), "data": csv,
        "wav_len": 0.5, "speed_pertub": False, "aug_prob": 0.0,
        "batch_size": 8, "num_workers": 2, "num_epoch": 2,
        "embedding_size": 16, "max_lr": 0.05, "min_lr": 0.005,
        "warmup_epoch": 1, "log_batch_freq": 1,
        "model": {"obj": "speaker3d_tpu.models.xvector.Xvector",
                  "args": {"feat_dim": 80, "hid_dim": 16, "stats_dim": 32,
                           "embed_dim": 16}}})


def exp_dir(config_path):
    with open(config_path) as f:
        return yaml.safe_load(f)["exp_dir"]


def conversation(seed=5):
    """A alone, A + B, B alone, around silence (tests/test_segmentation.py's
    overlap mixture)."""
    rng = np.random.default_rng(seed)
    a = speech_like(rng, 3 * FS, 180.0)
    b = speech_like(rng, 3 * FS, 900.0)
    sil = (0.002 * rng.standard_normal(FS)).astype(np.float32)
    wav = np.concatenate([sil, a, np.zeros(int(1.5 * FS), np.float32), sil])
    wav[int(2.5 * FS):int(5.5 * FS)] += b
    return wav


def diarize_both(root, tag, wav, sv_dir, vad_dir, seg_dir):
    """Both packages' diarization CLIs with the DNN front end on ``wav``;
    returns {name: (JAX bytes, port bytes)} for the RTTM and
    .vad_info.json."""
    from speaker3d_tpu.cli import infer_diarization as jdiar
    from speaker3d_tpu_torch.cli import infer_diarization as tdiar

    common = ["--wav", wav, "--exp_dir", sv_dir, "--vad_exp_dir", vad_dir,
              "--include_overlap", "--segmentation_exp_dir", seg_dir,
              "--speaker_num", "2", "--sidecar"]
    out = {pkg: os.path.join(root, f"{tag}_{pkg}_cli")
           for pkg in ("jax", "port")}
    jdiar.main(common + ["--out_dir", out["jax"]])
    tdiar.main(common + ["--out_dir", out["port"], "--device", "cpu"])
    base = os.path.splitext(os.path.basename(wav))[0]
    files = {}
    for name in (f"{base}.rttm", f"{base}.vad_info.json"):
        pair = []
        for pkg in ("jax", "port"):
            with open(os.path.join(out[pkg], name), "rb") as f:
                pair.append(f.read())
        files[name] = tuple(pair)
    return files


def check_identical_rttm(files):
    """Identical bytes; an RTTM whose speech lies around the conversation's
    tones (A at 1-4 s, B at 2.5-5.5 s)."""
    for name, (want, got) in files.items():
        assert got == want, name
    (rttm,) = [got for name, (_, got) in files.items()
               if name.endswith(".rttm")]
    lines = rttm.decode().splitlines()
    assert lines, "empty RTTM"
    total = sum(float(line.split()[4]) for line in lines)
    assert 3.0 < total < 6.5, lines
