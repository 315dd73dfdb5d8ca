"""Audio file IO: PCM WAV decode/encode, resampling, ``load_audio``,
Kaldi-style ``wav.scp`` / ``utt2spk`` lists, and YAML / JSON / line-list
helpers.

The port's own copy of ``speaker3d_tpu/utils/fileio.py``'s audio half and
of its list and file helpers (``load_yaml``, ``load_data_csv``,
``load_data_list``, ``load_wav_scp``, ``load_utt2spk``, ``write_wav_scp``,
``load_json_file``, ``write_json_file``, ``load_trans7time_list``,
``write_trans7time_list``): stdlib ``wave`` + numpy for PCM WAV, polyphase
resampling with scipy.
"""

from __future__ import annotations

import csv
import io
import json
import os
import wave
from math import gcd
from typing import Optional

import numpy as np


def _pcm_to_float(raw: bytes, sampwidth: int, n_channels: int, path):
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth} ({path})")
    return data.reshape(-1, n_channels).T


def read_wav(path):
    """Decode a PCM WAV file -> (float32 [channels, n] in [-1, 1], rate).

    One read plus a direct RIFF chunk parse; the stdlib ``wave`` module is
    the fallback for any layout the parser does not recognise, keeping its
    error behaviour."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
            raise ValueError("not RIFF/WAVE")
        pos, end = 12, len(buf)
        fmt = None
        while pos + 8 <= end:
            cid = buf[pos:pos + 4]
            size = int.from_bytes(buf[pos + 4:pos + 8], "little")
            body = pos + 8
            if cid == b"fmt ":
                if size < 16:
                    raise ValueError("short fmt chunk")
                audio_format = int.from_bytes(buf[body:body + 2], "little")
                n_channels = int.from_bytes(buf[body + 2:body + 4], "little")
                rate = int.from_bytes(buf[body + 4:body + 8], "little")
                bits = int.from_bytes(buf[body + 14:body + 16], "little")
                if audio_format != 1 or n_channels < 1 or bits % 8:
                    raise ValueError("non-PCM or odd fmt")  # wave fallback
                fmt = (n_channels, rate, bits // 8)
            elif cid == b"data":
                if fmt is None:
                    raise ValueError("data before fmt")
                n_channels, rate, sampwidth = fmt
                nbytes = min(size, end - body)
                frame = sampwidth * n_channels
                nbytes -= nbytes % frame
                raw = buf[body:body + nbytes]
                return _pcm_to_float(raw, sampwidth, n_channels, path), rate
            pos = body + size + (size & 1)
        raise ValueError("no data chunk")
    except ValueError:
        pass
    with wave.open(io.BytesIO(buf)) as w:
        n_channels = w.getnchannels()
        rate = w.getframerate()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    return _pcm_to_float(raw, sampwidth, n_channels, path), rate


def write_wav(path, wav, rate=16000):
    """Write mono/float [-1,1] (or [C, n]) as 16-bit PCM WAV."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = np.clip(wav.T * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(wav.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def resample(wav, orig_rate: int, new_rate: int):
    """Polyphase resampling along the last axis (scipy), float32 out."""
    if orig_rate == new_rate:
        return wav
    from scipy.signal import resample_poly

    g = gcd(orig_rate, new_rate)
    out = resample_poly(np.asarray(wav, dtype=np.float32), new_rate // g,
                        orig_rate // g, axis=-1)
    return out.astype(np.float32, copy=False)


def load_audio(input, ori_fs: Optional[int] = None, obj_fs: Optional[int] = None):
    """Universal audio loader -> float32 [1, n] mono."""
    if isinstance(input, (str, os.PathLike)):
        wav, fs = read_wav(os.fspath(input))
        wav = wav.mean(axis=0, keepdims=True)
        if obj_fs is not None and fs != obj_fs:
            wav = resample(wav, fs, obj_fs)
        return wav
    wav = np.asarray(input)
    if wav.dtype in (np.int16, np.int32, np.int64):
        wav = wav.astype(np.float32) / 32768.0
    wav = wav.astype(np.float32)
    if wav.ndim > 2:
        raise ValueError(f"audio must be 1-D or 2-D, got shape {wav.shape}")
    if wav.ndim == 2:
        if wav.shape[0] > wav.shape[1]:
            wav = wav.T
        wav = wav.mean(axis=0, keepdims=True)
    else:
        wav = wav[None]
    if ori_fs is not None and obj_fs is not None and ori_fs != obj_fs:
        wav = resample(wav, ori_fs, obj_fs)
    return wav


def load_wav_scp(fpath):
    """``key path`` per line -> {key: path} (the path may hold spaces)."""
    with open(fpath) as f:
        rows = [line.strip().split(None, 1) for line in f if line.strip()]
    return {k: v for k, v in rows}


def load_data_csv(fpath):
    """CSV index keyed by its mandatory unique 'ID' column: {id: row}."""
    with open(fpath, newline="") as f:
        result = {}
        for row in csv.DictReader(f, skipinitialspace=True):
            if "ID" not in row:
                raise KeyError("CSV file must have an 'ID' field with unique ids.")
            data_id = row.pop("ID")
            if data_id in result:
                raise ValueError(f"Duplicate id: {data_id}")
            result[data_id] = row
    return result


def load_yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def load_data_list(fpath):
    """{line index: stripped line}."""
    with open(fpath) as f:
        return {idx: line.strip() for idx, line in enumerate(f)}


def load_utt2spk(fpath):
    """``utt spk`` per line -> {utt: spk}."""
    return load_wav_scp(fpath)


def write_wav_scp(fpath, wav_scp):
    """{key: value} -> ``key value`` per line."""
    with open(fpath, "w") as f:
        for key, value in wav_scp.items():
            f.write(f"{key} {value}\n")


def load_json_file(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_json_file(path, data):
    """``data`` as indented UTF-8 JSON; ``path`` must end in ``.json``."""
    if not str(path).lower().endswith(".json"):
        raise ValueError(f"not a .json path: {path}")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, ensure_ascii=False)


def load_trans7time_list(path):
    """Lines of ``spk_id start end [text...]`` -> [(spk_id, start, end,
    text)], the text's words joined without spaces."""
    out = []
    with open(path) as f:
        for index, line in enumerate(f):
            item = line.strip().split()
            if not item:
                continue
            if len(item) <= 2:
                raise ValueError(f"{path}: item {index} = {item}")
            text = "" if len(item) == 3 else "".join(item[3:])
            out.append((item[0], float(item[1]), float(item[2]), text))
    return out


def write_trans7time_list(path, trans7time_list):
    """[(spk_id, start, end, text)] -> ``spk_id start end text`` per line,
    line breaks dropped from the text."""
    with open(path, "w") as f:
        for spk_id, st, ed, text in trans7time_list:
            text = str(text).replace("\n", "").replace("\r", "")
            f.write(f"{spk_id} {st} {ed} {text}\n")
