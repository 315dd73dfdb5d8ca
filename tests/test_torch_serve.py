"""The PyTorch port's embedding server (serve.py, cli/serve_embedding.py)
against the JAX package's, on the CPU.

- The port's ``EmbeddingServer`` and the JAX one on the same small
  ERes2NetV2 weights (17.8M geometry, so layer1-2 run the Res2 block
  kernel's plain version here): embeddings at rtol = atol = 3e-4 after
  dividing by the reference's largest magnitude, one chunk size and
  duration buckets.
- The engine, socket, bucket and leftover-deadline tests of
  ``tests/test_serve.py``, on a torch stand-in ``embed_fn``; chunks queued
  during a dispatch sharing the next batch (where the port's dispatcher
  differs from the JAX one).
- The wire: identical responses from both servers to a request without
  audio and to an empty waveform.
- The CLI: ``--exp_dir`` refused naming M12; a server process on the CPU
  answering one request.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from speaker3d_tpu.eval.embedding import build_embedding_fn as jax_embedding_fn
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu.serve import EmbeddingServer as JaxServer
from speaker3d_tpu.serve import serve as jax_serve
from speaker3d_tpu_torch.cli import serve_embedding
from speaker3d_tpu_torch.cli.registry import SUPPORTS
from speaker3d_tpu_torch.diar.pipeline import circle_pad
from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.serve import EmbeddingServer, request_embedding, serve
from speaker3d_tpu_torch.utils.fileio import write_wav
from tests.test_torch_eres2netv2 import jax_variables, port_model
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_17M = dict(num_blocks=(2, 2, 1, 1), m_channels=16, feat_dim=80,
                 embedding_size=32, base_width=26, scale=2, expansion=2)
MODEL_ID = "iic/speech_eres2netv2_sv_zh-cn_16k-common"


@pytest.fixture(scope="module")
def embed_fn():
    """Deterministic stand-in embedder: per-sample fbank stats -> [D]."""
    fbank = KaldiFbank(FbankConfig(), device="cpu")

    def fn(wavs):
        with torch.inference_mode():
            feats = fbank(torch.as_tensor(wavs))
            return torch.cat([feats.mean(dim=1), feats.std(dim=1)], dim=-1)

    return fn


@pytest.fixture(scope="module")
def both_models():
    jm = JaxERes2NetV2(**SMALL_17M)
    variables = jax_variables(jm, seed=11)
    return (jax_embedding_fn(jm, variables, precision="high"),
            build_embedding_fn(port_model(variables, **SMALL_17M),
                               device="cpu", precision="high"))


@pytest.mark.parametrize("buckets", [None, [0.5, 1.0, 2.0]])
def test_embeddings_match_jax_server(both_models, buckets):
    """2 s chunks, a 4 s cap: one request inside a chunk, one over two, one
    past the cap; with buckets the short ones pad to 0.5 and 1 s."""
    jfn, tfn = both_models
    rng = np.random.default_rng(12)
    wavs = [(0.1 * rng.standard_normal(int(s * FS))).astype(np.float32)
            for s in (0.4, 0.9, 3.3, 5.1)]
    kw = dict(batch_size=4, max_wait_ms=5.0, chunk_seconds=2.0,
              max_seconds=4.0, bucket_seconds=buckets)
    out = {}
    for name, cls, fn in (("jax", JaxServer, jfn), ("torch", EmbeddingServer,
                                                    tfn)):
        srv = cls(fn, **kw)
        try:
            futs = [srv.submit(w) for w in wavs]
            out[name] = np.stack([f.result(timeout=300) for f in futs])
        finally:
            srv.close()
    scale = float(np.abs(out["jax"]).max())
    assert out["torch"].shape == (4, 32)
    np.testing.assert_allclose(out["torch"] / scale, out["jax"] / scale,
                               rtol=3e-4, atol=3e-4)


def test_engine_batching_and_chunk_mean(embed_fn):
    rng = np.random.default_rng(0)
    srv = EmbeddingServer(embed_fn, batch_size=4, max_wait_ms=5.0)
    try:
        short = (0.1 * rng.standard_normal(3 * FS)).astype(np.float32)
        long = (0.1 * rng.standard_normal(23 * FS)).astype(np.float32)
        futs = [srv.submit(short), srv.submit(long), srv.submit(short)]
        out = [f.result(timeout=120) for f in futs]
        assert out[0].shape == out[1].shape
        np.testing.assert_allclose(out[0], out[2], rtol=1e-5, atol=1e-5)

        # chunk-mean semantics match the batch-extraction path
        chunk = int(10 * FS)
        chunks = np.stack([circle_pad(long[s:s + chunk], chunk)
                           for s in range(0, len(long), chunk)])
        want = embed_fn(np.concatenate(
            [chunks, np.zeros((1, chunk), np.float32)]))[: len(chunks)]
        np.testing.assert_allclose(out[1], want.mean(dim=0).numpy(),
                                   rtol=1e-4, atol=1e-4)

        with pytest.raises(ValueError, match="empty waveform"):
            srv.submit(np.zeros(0, np.float32)).result(timeout=5)
    finally:
        srv.close()


def test_one_error_resolves_every_waiter_of_the_batch():
    calls = []

    def failing(wavs):
        calls.append(wavs.shape)
        raise RuntimeError("device lost")

    srv = EmbeddingServer(failing, batch_size=4, max_wait_ms=5.0,
                          chunk_seconds=1.0)
    try:
        futs = [srv.submit(np.ones(n, np.float32)) for n in (800, 2400, 100)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device lost"):
                f.result(timeout=30)
    finally:
        srv.close()
    assert calls and all(s == (4, FS) for s in calls)


def test_chunks_queued_during_a_dispatch_share_the_next_batch():
    """Chunks that arrive while a dispatch runs are all overdue when it
    ends; the dispatcher takes them all before it checks the deadlines, so
    they go out in full batches (the JAX server's one-per-turn loop sends
    each in a batch of its own: seven dispatches here)."""
    rows = []

    def slow(wavs):
        rows.append(int((np.abs(wavs).sum(axis=1) > 0).sum()))
        time.sleep(0.2)
        return torch.zeros(len(wavs), 3)

    srv = EmbeddingServer(slow, batch_size=4, max_wait_ms=5.0,
                          chunk_seconds=0.1)
    try:
        futs = [srv.submit(np.ones(800, np.float32))]
        time.sleep(0.05)  # the first dispatch is running
        futs += [srv.submit(np.ones(800, np.float32)) for _ in range(6)]
        for f in futs:
            f.result(timeout=30)
    finally:
        srv.close()
    assert sum(rows) == 7 and max(rows) == 4 and len(rows) <= 3, rows


def _start(serve_fn, **kw):
    ready, holder = threading.Event(), []
    t = threading.Thread(target=serve_fn, kwargs=dict(
        ready_event=ready, server_holder=holder, **kw), daemon=True)
    t.start()
    assert ready.wait(timeout=60)
    return holder[0], t


def test_socket_server_end_to_end(embed_fn, tmp_path):
    sock = os.path.join(tmp_path, "emb.sock")
    server, thread = _start(serve, embed_fn=embed_fn, unix_socket=sock,
                            batch_size=4, max_wait_ms=5.0)
    try:
        rng = np.random.default_rng(1)
        wav = (0.1 * rng.standard_normal(2 * FS)).astype(np.float32)
        p = os.path.join(tmp_path, "a.wav")
        write_wav(p, wav, FS)

        e_file = request_embedding(sock, wav_path=p, req_id="f")
        e_pcm = request_embedding(sock, pcm=wav, req_id="p")
        assert e_file.shape == e_pcm.shape
        # the PCM16 round trip perturbs near-empty log-mel bins; cosine is
        # the invariant for embeddings
        cos = float(np.dot(e_file, e_pcm)
                    / (np.linalg.norm(e_file) * np.linalg.norm(e_pcm)))
        assert cos > 0.9999, cos

        # errors come back as protocol errors, not dropped connections
        with pytest.raises(RuntimeError):
            request_embedding(sock, wav_path="/does/not/exist.wav",
                              req_id="e")

        # concurrent clients micro-batch into one dispatch
        results = {}

        def client(k):
            results[k] = request_embedding(sock, pcm=wav, req_id=str(k))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert len(results) == 4
        for v in results.values():
            np.testing.assert_allclose(v, e_pcm, rtol=1e-4, atol=1e-4)
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_engine_bucketed_requests(embed_fn):
    """Short requests embed at their smallest holding bucket; results match
    the direct per-bucket computation (the plan of cli/extract
    --buckets)."""
    rng = np.random.default_rng(1)
    srv = EmbeddingServer(embed_fn, batch_size=4, max_wait_ms=5.0,
                          bucket_seconds=[1.5, 3.0, 6.0, 10.0])
    try:
        reqs = {
            "tiny": (0.1 * rng.standard_normal(1 * FS)).astype(np.float32),
            "mid": (0.1 * rng.standard_normal(4 * FS)).astype(np.float32),
            "long": (0.1 * rng.standard_normal(13 * FS)).astype(np.float32),
        }
        futs = {k: srv.submit(w) for k, w in reqs.items()}
        out = {k: f.result(timeout=120) for k, f in futs.items()}

        def emb(w, pad_s):
            return embed_fn(circle_pad(w, int(pad_s * FS))[None])[0].numpy()

        np.testing.assert_allclose(out["tiny"], emb(reqs["tiny"], 1.5),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["mid"], emb(reqs["mid"], 6.0),
                                   rtol=1e-4, atol=1e-4)
        chunk = int(10 * FS)
        want = np.mean([emb(reqs["long"][:chunk], 10.0),
                        emb(reqs["long"][chunk:], 3.0)], axis=0)
        np.testing.assert_allclose(out["long"], want, rtol=1e-4, atol=1e-4)
    finally:
        srv.close()


def test_leftover_chunks_keep_their_deadline(embed_fn):
    """A burst larger than batch_size drains within about one max_wait:
    queued items carry their enqueue timestamps, so the leftover after a
    full-batch dispatch does not restart the wait clock."""
    rng = np.random.default_rng(3)
    srv = EmbeddingServer(embed_fn, batch_size=4, max_wait_ms=300.0)
    try:
        srv.embed(rng.standard_normal(FS).astype(np.float32))  # warm up
        # 6 one-chunk requests: one full batch of 4 dispatches at once, the
        # 2 leftovers must flush at ~max_wait, not 2x
        wavs = [(0.1 * rng.standard_normal(FS)).astype(np.float32)
                for _ in range(6)]
        t0 = time.monotonic()
        futs = [srv.submit(w) for w in wavs]
        for f in futs:
            f.result(timeout=30)
        elapsed = time.monotonic() - t0
        assert elapsed < 0.55, (
            f"burst drained in {elapsed:.3f}s; leftover chunks waited past "
            f"their original deadline (max_wait=0.3)")
    finally:
        srv.close()


def _raw(sock_path, line: bytes) -> dict:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(60)
    s.connect(sock_path)
    try:
        s.sendall(line + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            part = s.recv(1 << 16)
            if not part:
                break
            buf += part
        return json.loads(buf)
    finally:
        s.close()


def test_error_responses_equal_jax(embed_fn, tmp_path):
    servers = []
    try:
        socks = {}
        for name, fn in (("jax", jax_serve), ("torch", serve)):
            socks[name] = os.path.join(tmp_path, f"{name}.sock")
            servers.append(_start(fn, embed_fn=embed_fn,
                                  unix_socket=socks[name], batch_size=2,
                                  max_wait_ms=5.0))
        for line in (b'{"id": "bad"}', b'{"id": "empty", "pcm_b64": ""}',
                     b'["not", "an", "object"]', b"not json"):
            got, want = _raw(socks["torch"], line), _raw(socks["jax"], line)
            assert got == want and "error" in got, (line, got, want)
        assert _raw(socks["torch"], b'{"id": "bad"}') == {
            "id": "bad", "error": "ValueError: request needs 'wav' or "
                                  "'pcm_b64'"}
    finally:
        for server, thread in servers:
            server.shutdown()
            thread.join(timeout=30)


def test_cli_refuses_exp_dir_naming_m12(tmp_path):
    """``--exp_dir`` is open since the trainer (M12) was ported: a
    directory without an experiment is refused loudly, and neither flag
    stops naming what is required."""
    assert serve_embedding.get_args([]).device == "cuda"
    with pytest.raises(FileNotFoundError, match="config.yaml"):
        serve_embedding.main(["--exp_dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--exp_dir / --model_id"):
        serve_embedding.main(["--device", "cpu"])


def test_cli_process_on_the_cpu_answers_a_request(tmp_path):
    """``python -m speaker3d_tpu_torch.cli.serve_embedding --device cpu
    --port 0``: the "listening on" line, one request, then terminated."""
    small = dict(num_blocks=(1, 1, 1, 1), m_channels=8, embedding_size=16)
    ckpt = tmp_path / "pretrained" / MODEL_ID / SUPPORTS[MODEL_ID]["model_pt"]
    os.makedirs(ckpt.parent)
    from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2

    model = ERes2NetV2(**small)
    torch.save(model.state_dict(), ckpt)
    # the registry's arguments, narrowed, in the child process
    code = ("import sys; from speaker3d_tpu_torch.cli import registry, "
            "serve_embedding; registry.SUPPORTS[sys.argv[1]]['model']['args']"
            f".update({small!r}); serve_embedding.main(sys.argv[2:])")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, MODEL_ID, "--model_id", MODEL_ID,
         "--local_model_dir", str(tmp_path / "pretrained"), "--device", "cpu",
         "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        assert m, line
        wav = (0.1 * np.random.default_rng(13).standard_normal(FS)).astype(
            np.float32)
        emb = request_embedding((m.group(1), int(m.group(2))), pcm=wav)
        want = build_embedding_fn(model, device="cpu", precision="high")(
            circle_pad(wav, 10 * FS)[None])[0].numpy()
        np.testing.assert_allclose(emb, want, rtol=1e-4, atol=1e-4)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
