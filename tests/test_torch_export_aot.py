"""The port's AOTInductor serving artifact (cli/export_speaker_embedding.py
``export_aot_artifact``) on the CPU, against the JAX package's StableHLO
artifact.

One module fixture compiles one package (the 0.5 s bucket, 48 frames) of a
tiny ERes2NetV2 in the 17.8M model's geometry, whose layer1-2 blocks call
``s3d::res2_block``; the two-bucket layout (0.25 and 0.5 s, 23 and 48
frames) is checked with the compiles stubbed. The package runs in Python
(``torch._inductor.aoti_load_package``) against the eager port (rtol =
atol = 3e-4 of the scale, as tests/test_torch_eres2netv2.py) and the JAX
model; ``aot.json`` holds the JAX artifact's keys and values but for
``format`` and the port's ``precision`` and ``device``.
"""

import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.cli import export_speaker_embedding as jex
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu_torch.cli import export_speaker_embedding as tex
from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk
from tests.test_torch_eres2netv2 import (
    assert_close_scaled, jax_variables, port_model)
from tests.torch_threads import cap_torch_threads  # noqa: F401

SMALL = dict(num_blocks=(1, 1, 1, 1), m_channels=8, feat_dim=80,
             embedding_size=16, base_width=26, scale=2, expansion=2)
BUCKETS = [0.25, 0.5]
PORT_ONLY = {"format", "precision", "device"}


def _stub_compile(monkeypatch):
    """Write an empty file where a package would go: the layout alone."""
    written = []

    def stub(program, package_path):
        written.append(package_path)
        open(package_path, "wb").close()
        return package_path

    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package", stub)
    return written


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One real compile: the 0.5 s bucket's package, alone in its dir."""
    jm = JaxERes2NetV2(**SMALL)
    variables = jax_variables(jm, t=48)
    model = port_model(variables, **SMALL)
    out = str(tmp_path_factory.mktemp("aot"))
    meta = tex.export_aot_artifact(model, out, bucket_seconds=BUCKETS[1:],
                                   device="cpu")
    return jm, variables, model, out, meta


def _json(folder):
    with open(os.path.join(folder, "aot.json")) as f:
        return json.load(f)


def test_bucket_layout_matches_jax(artifacts, tmp_path, monkeypatch):
    """Both buckets (the compiles stubbed: the layout alone) against the
    JAX artifact: the files, the frames per bucket, aot.json."""
    jm, variables, model = artifacts[:3]
    written = _stub_compile(monkeypatch)
    out, jout = str(tmp_path / "a"), str(tmp_path / "j")
    meta = tex.export_aot_artifact(model, out, bucket_seconds=BUCKETS,
                                   device="cpu")
    jex.export_aot_artifact(jm, variables, jout, bucket_seconds=BUCKETS)
    js, jjs = _json(out), _json(jout)
    assert js == meta
    assert set(js) == set(jjs) | {"precision", "device"}
    assert {k: v for k, v in js.items() if k not in PORT_ONLY} == {
        k: v for k, v in jjs.items() if k not in PORT_ONLY}
    assert (js["precision"], js["device"]) == ("high", "cpu")
    assert [b["frames"] for b in js["buckets"]] == [23, 48]
    for b in js["buckets"]:
        assert b["frames"] == tex.frames_for_samples(b["samples"])
    assert written == [os.path.join(out, f"model_f{f}.pt2") for f in (23, 48)]
    assert sorted(os.listdir(out)) == [
        "aot.json", "model_f23.pt2", "model_f48.pt2"]
    assert {f.split(".")[0] for f in os.listdir(jout)} == {
        "aot", "model_f23", "model_f48"}
    assert sorted(os.listdir(artifacts[3])) == ["aot.json", "model_f48.pt2"]


def test_packages_carry_the_res2_operator(artifacts):
    out = artifacts[3]
    for f in ("model_f48.pt2",):
        with zipfile.ZipFile(os.path.join(out, f)) as z:
            assert any(b"s3d::res2_block" in z.read(n) or
                       b"s3d.res2_block" in z.read(n)
                       for n in z.namelist() if n.endswith(".json"))


def test_packages_run_in_python_against_eager_and_jax(artifacts,
                                                      monkeypatch):
    """Each bucket's package at [1, frames, 80]: the operator's CPU
    implementation (the plain version) runs once per layer1-2 block, and
    the embedding equals the eager port's and the JAX model's."""
    jm, variables, model, out, meta = artifacts
    calls = []
    plain = rk.res2_block_plain
    monkeypatch.setattr(rk, "res2_block_plain",
                        lambda *a: calls.append(1) or plain(*a))
    for i, b in enumerate(meta["buckets"]):
        runner = torch._inductor.aoti_load_package(
            os.path.join(out, f"model_f{b['frames']}.pt2"))
        x = np.random.default_rng(i).standard_normal(
            (1, b["frames"], 80)).astype(np.float32)
        del calls[:]
        with torch.inference_mode():
            got = runner(torch.from_numpy(x))
            got = (got[0] if isinstance(got, (list, tuple)) else got).numpy()
        assert len(calls) == sum(SMALL["num_blocks"][:2])
        with torch.inference_mode():
            want = model(torch.from_numpy(x)).numpy()
        assert_close_scaled(got, want, 3e-4)
        assert_close_scaled(got, np.asarray(jax.jit(jm.apply)(variables, x)),
                            3e-4)


def test_single_shape_layout_matches_jax(artifacts, tmp_path, monkeypatch):
    """Without buckets: one model.pt2 of --frames and the JAX meta's
    single-shape keys (the compile stubbed: the layout alone)."""
    jm, variables, model = artifacts[:3]
    written = _stub_compile(monkeypatch)
    out, jout = str(tmp_path / "a"), str(tmp_path / "j")
    meta = tex.export_aot_artifact(model, out, frames=30, device="cpu")
    jmeta = jex.export_aot_artifact(jm, variables, jout, frames=30)
    assert written == [os.path.join(out, "model.pt2")]
    assert {k: v for k, v in meta.items() if k not in PORT_ONLY} == {
        k: v for k, v in jmeta.items() if k not in PORT_ONLY}
    assert _json(out) == meta and meta["frames"] == 30
