"""Micro-batched speaker-embedding serving daemon.

The counterpart of ``speaker3d_tpu/serve.py``: a long-lived server that
keeps one embedding function (fbank kernel + backbone on the card) loaded
and batches concurrent requests onto the device.

- Fixed shapes: requests are cut into 10 s circle-padded chunks (the
  ``infer_sv_batch`` plan, capped at 90 s) and packed into a zero-padded
  [batch_size, chunk] buffer; a request's embedding is the mean over its
  chunks.
- Micro-batching: one dispatcher thread drains the request queue. A bucket
  dispatches when it holds ``batch_size`` chunks, or when its oldest chunk
  has waited ``max_wait_ms`` since it was enqueued. Unlike the JAX server,
  the dispatcher takes every queued chunk before it checks the deadlines,
  so chunks that queued during a dispatch share the next batch.
- The socket front end speaks newline-delimited JSON over a unix socket or
  TCP: {"id": ..., "wav": "/path.wav"} or {"id": ..., "pcm_b64": <base64
  float32 little-endian mono>, "fs": 16000} -> {"id", "embedding": [...],
  "dim"} or {"id", "error"}.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import socket
import socketserver
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from speaker3d_tpu_torch.diar.pipeline import circle_pad
from speaker3d_tpu_torch.eval.chunking import plan_chunks
from speaker3d_tpu_torch.utils.fileio import load_audio

CHUNK_SECONDS = 10.0
MAX_SECONDS = 90.0


class EmbeddingServer:
    """Micro-batching executor around an ``embed_fn`` ([B, L] float32 ->
    [B, D], a tensor on any device or an array).

    Only the dispatcher thread calls ``embed_fn``: ``build_embedding_fn``'s
    precision sets cuDNN's and cuBLAS's TF32 flags, which are global to the
    process, for the length of each call, so two threads embedding at once
    could leave them wrong. The output is copied to the host once per batch.

    ``bucket_seconds``: optional duration buckets (ascending; the last is
    the chunk size). Chunks micro-batch per bucket, so a 3 s request embeds
    a 3 s batch instead of padding to 10 s: the plan of ``cli/extract
    --buckets``. None keeps one bucket, the chunk.
    """

    def __init__(self, embed_fn, batch_size: int = 16,
                 max_wait_ms: float = 10.0, sample_rate: int = 16000,
                 chunk_seconds: float = CHUNK_SECONDS,
                 max_seconds: float = MAX_SECONDS,
                 bucket_seconds=None):
        self.embed_fn = embed_fn
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.fs = sample_rate
        self.buckets = sorted(int(b * sample_rate) for b in
                              (bucket_seconds or [chunk_seconds]))
        self.chunk = self.buckets[-1]
        self.max_len = int(max_seconds * sample_rate)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- client API --------------------------------------------------------

    def submit(self, wav: np.ndarray) -> Future:
        """Queue a waveform [n] float32; resolves to the embedding [D]."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        fut: Future = Future()
        if wav.shape[0] == 0:
            fut.set_exception(ValueError("empty waveform"))
            return fut
        plan = plan_chunks(wav.shape[0], self.buckets, self.max_len)
        state = {"want": len(plan), "got": [], "future": fut}
        ts = time.monotonic()
        for c in plan:
            self._q.put((state,
                         circle_pad(wav[c.start:c.start + c.length],
                                    c.padded), c.padded, ts))
        return fut

    def embed(self, wav: np.ndarray, timeout: Optional[float] = 60.0):
        return self.submit(wav).result(timeout=timeout)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    # ---- dispatcher --------------------------------------------------------

    def _dispatch(self, blen, batch):
        wavs = np.zeros((self.batch_size, blen), np.float32)
        for i, (_, c, *_rest) in enumerate(batch):
            wavs[i] = c
        try:
            embs = torch.as_tensor(self.embed_fn(wavs))[:len(batch)]
            embs = embs.to(device="cpu", dtype=torch.float32).numpy()
        except Exception as e:  # resolve all waiters with the error
            for state, *_rest in batch:
                if not state["future"].done():
                    state["future"].set_exception(e)
            return
        for (state, *_rest), e in zip(batch, embs):
            state["got"].append(e)
            if len(state["got"]) == state["want"] \
                    and not state["future"].done():
                state["future"].set_result(
                    np.mean(np.stack(state["got"]), axis=0))

    def _loop(self):
        # Each queued item carries its enqueue timestamp, and a bucket's
        # deadline is its oldest pending item's plus max_wait: leftovers of
        # a full-batch dispatch keep their own deadline (a per-bucket timer
        # reset at each dispatch would let them wait up to 2x max_wait).
        pending = {b: [] for b in self.buckets}
        while not self._stop.is_set():
            oldest = [items[0][3] for items in pending.values() if items]
            timeout = 0.1 if not oldest else max(
                min(oldest) + self.max_wait - time.monotonic(), 0.0) + 1e-4
            try:
                item = self._q.get(timeout=timeout)
                pending[item[2]].append(item)
                # everything queued meanwhile joins its bucket before the
                # deadlines are checked: after a dispatch longer than
                # max_wait every waiting chunk is overdue, and taking one
                # per turn (as the JAX server does) sent them off one at a
                # time, each in a whole padded batch
                while True:
                    item = self._q.get_nowait()
                    pending[item[2]].append(item)
            except queue.Empty:
                pass
            for b in self.buckets:
                # the clock is read again per dispatch: a slow embed_fn call
                # must not hold the other buckets to a stale time
                while len(pending[b]) >= self.batch_size or (
                        pending[b]
                        and time.monotonic() - pending[b][0][3] >= self.max_wait):
                    batch = pending[b][: self.batch_size]
                    pending[b] = pending[b][self.batch_size:]
                    self._dispatch(b, batch)


# ---- socket front end -------------------------------------------------------

def _decode_request(req: dict, sample_rate: int) -> np.ndarray:
    if "wav" in req:
        return np.asarray(load_audio(req["wav"], obj_fs=sample_rate))[0]
    if "pcm_b64" in req:
        pcm = np.frombuffer(base64.b64decode(req["pcm_b64"]), np.float32)
        fs = int(req.get("fs", sample_rate))
        if fs != sample_rate:
            return np.asarray(load_audio(pcm[None], fs, sample_rate))[0]
        return pcm
    raise ValueError("request needs 'wav' or 'pcm_b64'")


def serve(embed_fn, *, unix_socket: Optional[str] = None,
          host: str = "127.0.0.1", port: int = 0,
          batch_size: int = 16, max_wait_ms: float = 10.0,
          sample_rate: int = 16000, ready_event: Optional[threading.Event] = None,
          server_holder: Optional[list] = None, bucket_seconds=None):
    """Blocking JSON-lines server. Returns only on ``shutdown()`` of the
    server handed to ``server_holder``."""
    engine = EmbeddingServer(embed_fn, batch_size=batch_size,
                             max_wait_ms=max_wait_ms,
                             sample_rate=sample_rate,
                             bucket_seconds=bucket_seconds)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    emb = engine.embed(_decode_request(req, sample_rate))
                    resp = {"id": req.get("id"),
                            "embedding": [float(x) for x in emb],
                            "dim": int(emb.shape[0])}
                except Exception as e:  # the error goes back on the wire
                    resp = {"id": None, "error": f"{type(e).__name__}: {e}"}
                    try:
                        resp["id"] = req.get("id")
                    except Exception:  # the line was not a JSON object
                        pass
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()

    if unix_socket:
        if os.path.exists(unix_socket):
            os.unlink(unix_socket)

        class Srv(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True

        server = Srv(unix_socket, Handler)
        addr = unix_socket
    else:
        class Srv(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        server = Srv((host, port), Handler)
        addr = f"{server.server_address[0]}:{server.server_address[1]}"
    if server_holder is not None:
        server_holder.append(server)
    print(f"embedding server listening on {addr}", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.close()


def request_embedding(sock_path_or_addr, wav_path: Optional[str] = None,
                      pcm: Optional[np.ndarray] = None, req_id: str = "0",
                      timeout: float = 120.0) -> np.ndarray:
    """One-shot client: a unix socket path or a (host, port) tuple; raises
    ``RuntimeError`` with the server's error text."""
    if isinstance(sock_path_or_addr, tuple):
        s = socket.create_connection(sock_path_or_addr, timeout=timeout)
    else:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(sock_path_or_addr)
    try:
        req = {"id": req_id}
        if wav_path is not None:
            req["wav"] = wav_path
        else:
            req["pcm_b64"] = base64.b64encode(
                np.asarray(pcm, np.float32).tobytes()).decode()
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            part = s.recv(1 << 20)
            if not part:
                break
            buf += part
        resp = json.loads(buf)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return np.asarray(resp["embedding"], np.float32)
    finally:
        s.close()
