"""Native Kaldi binary ark/scp reader+writer for float vectors/matrices.

The port's own copy of ``speaker3d_tpu/utils/kaldi_ark.py``: it writes the
same bytes.

The reference writes extraction results as Kaldi archives via
``kaldiio.WriteHelper('ark,scp:...')`` (reference: speakerlab/bin/
extract.py:79, bin/infer_sv_batch.py ark mode); kaldiio is not available
in this environment, so this module implements the on-disk format
directly so archives interoperate with Kaldi/kaldiio tooling:

    record := key ' ' '\\0B' header data
    header := 'FV ' '\\x04' int32(dim)                  (float32 vector)
            | 'FM ' '\\x04' int32(rows) '\\x04' int32(cols)  (float32 matrix)
    scp    := 'key path:offset' per line, offset -> the '\\0B' byte

Only float32 ("FV"/"FM") records are produced, matching what the
reference writes for embeddings; the reader also accepts DV/DM (float64).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_BIN = b"\0B"


def _write_record(f, key: str, arr: np.ndarray) -> int:
    """Append one record; returns the offset of the binary header."""
    if not key or any(c.isspace() for c in key) or "\0" in key:
        # a space/NUL in the key silently corrupts the archive (the reader
        # delimits keys on ' '): fail at write time instead
        raise ValueError(f"invalid kaldi ark key {key!r} "
                         "(must be non-empty, no whitespace/NUL)")
    arr = np.asarray(arr)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    f.write(key.encode() + b" ")
    offset = f.tell()
    f.write(_BIN)
    if arr.ndim == 1:
        f.write(b"FV " + b"\x04" + struct.pack("<i", arr.shape[0]))
    elif arr.ndim == 2:
        f.write(b"FM " + b"\x04" + struct.pack("<i", arr.shape[0])
                + b"\x04" + struct.pack("<i", arr.shape[1]))
    else:
        raise ValueError(f"kaldi ark supports 1-D/2-D, got {arr.ndim}-D")
    f.write(arr.tobytes())
    return offset


def write_ark_scp(ark_path: str, data: Dict[str, np.ndarray],
                  scp_path: Optional[str] = None) -> None:
    """Write ``data`` to a binary ark (+ scp index when given)."""
    scp_lines = []
    with open(ark_path, "wb") as f:
        for key, arr in data.items():
            offset = _write_record(f, key, arr)
            scp_lines.append(f"{key} {ark_path}:{offset}\n")
    if scp_path:
        with open(scp_path, "w") as f:
            f.writelines(scp_lines)


_HEADERS = {b"FV": (np.float32, 1), b"FM": (np.float32, 2),
            b"DV": (np.float64, 1), b"DM": (np.float64, 2)}


def _read_int(f) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"unsupported kaldi int size marker {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_value(f) -> np.ndarray:
    if f.read(2) != _BIN:
        raise ValueError("not a kaldi binary record (missing \\0B)")
    kind = f.read(2)
    if kind not in _HEADERS:
        raise ValueError(f"unsupported kaldi record type {kind!r}")
    if f.read(1) != b" ":
        raise ValueError("malformed kaldi header")
    dtype, ndim = _HEADERS[kind]
    if ndim == 1:
        dim = _read_int(f)
        buf = f.read(dim * dtype().itemsize)
        if len(buf) != dim * dtype().itemsize:
            raise ValueError("truncated kaldi ark record")
        # copy: frombuffer views are read-only, unlike the npz/npy loaders
        return np.frombuffer(buf, dtype, count=dim).copy()
    rows, cols = _read_int(f), _read_int(f)
    buf = f.read(rows * cols * dtype().itemsize)
    if len(buf) != rows * cols * dtype().itemsize:
        raise ValueError("truncated kaldi ark record")
    return np.frombuffer(buf, dtype, count=rows * cols).reshape(
        rows, cols).copy()


def iter_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (key, array) sequentially from a binary ark."""
    with open(ark_path, "rb") as f:
        while True:
            key = bytearray()
            ch = f.read(1)
            if not ch:
                return
            while ch != b" ":
                key += ch
                ch = f.read(1)
                if not ch:
                    raise ValueError("truncated kaldi ark key")
            yield key.decode(), _read_value(f)


def read_ark(ark_path: str) -> Dict[str, np.ndarray]:
    return dict(iter_ark(ark_path))


def read_scp(scp_path: str) -> Dict[str, np.ndarray]:
    """Random-access read via an scp index (key path:offset)."""
    out = {}
    handles = {}
    try:
        with open(scp_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, loc = line.split(None, 1)
                path, offset = loc.rsplit(":", 1)
                if path not in handles:
                    handles[path] = open(path, "rb")
                h = handles[path]
                h.seek(int(offset))
                out[key] = _read_value(h)
    finally:
        for h in handles.values():
            h.close()
    return out
