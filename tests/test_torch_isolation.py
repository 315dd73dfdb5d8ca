"""The PyTorch package stands alone and defaults to the card.

- Every module of ``speaker3d_tpu_torch`` imports in a fresh interpreter in
  which ``jax`` and ``speaker3d_tpu`` cannot be imported.
- No module, and not ``chip_smoke.py``, names ``jax``/``flax``,
  ``speaker3d_tpu`` or ``sklearn`` in an import (AST scan), so no later
  slice reaches for the JAX package or for scikit-learn, which the card's
  machine lacks.
- The entry points raise without a CUDA device unless the caller passes
  ``device="cpu"``: nothing falls back to the CPU on its own.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import speaker3d_tpu_torch

PKG_DIR = os.path.dirname(speaker3d_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "speaker3d_tpu", "sklearn")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="speaker3d_tpu_torch."))


def test_package_has_the_slice_modules():
    mods = set(_modules())
    for name in ("device", "kernels.build", "ops.fbank",
                 "ops.kernels.fbank_kernel", "ops.kernels.res2_block_kernel",
                 "models.eres2netv2", "compat.flax_convert", "eval.embedding",
                 "diar.vad", "diar.ahc_nnchain", "diar.cluster",
                 "diar.pipeline", "cli.registry", "cli.infer_diarization",
                 "tools.probe_ops", "eval.chunking", "eval.scoring",
                 "utils.kaldi_ark", "utils.metrics", "cli.extract",
                 "cli.infer_sv", "cli.infer_sv_batch",
                 "cli.compute_score_metrics", "models.campplus",
                 "models.eres2net", "models.ecapa_tdnn", "serve",
                 "cli.serve_embedding", "diar.kmeans", "diar.hdbscan_native",
                 "diar.umap_native", "diar.der", "cli.compute_der",
                 "cli.check_single_speaker", "cli.analyze_similarity",
                 "models.pooling", "models.resnet", "models.res2net",
                 "models.xvector", "models.classifier"):
        assert f"speaker3d_tpu_torch.{name}" in mods, name


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _sources():
    for dirpath, _, files in os.walk(PKG_DIR):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_imports_in_source():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            offenders += [(path, n) for n in names
                          if n.split(".")[0] in FORBIDDEN]
    assert any(p.endswith("chip_smoke.py") for p in _sources())
    assert not offenders, offenders


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a CUDA card")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from speaker3d_tpu_torch.cli import (
        analyze_similarity, check_single_speaker, compute_der,
        compute_score_metrics, extract, infer_diarization, infer_sv,
        infer_sv_batch, serve_embedding)
    from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
    from speaker3d_tpu_torch.tools import probe_ops

    model = ERes2NetV2(num_blocks=(1, 1, 1, 1), m_channels=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_embedding_fn(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiarizationPipeline(lambda w: w)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_diarization.main(["--wav", "a.wav", "--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_ops.main([])
    for cli, argv in ((extract, ["--model_id", "m", "--data", "s"]),
                      (infer_sv_batch, ["--wavs", "w"]),
                      (compute_score_metrics, ["--enrol_data", "e",
                                               "--test_data", "e",
                                               "--trials", "t"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv + ["--out_dir" if cli is not compute_score_metrics
                             else "--scores_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_sv.main(["--model_id", "m", "--wavs", "a.wav"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_embedding.main(["--model_id", "m"])
    for cli, argv in ((compute_der, ["--ref", "r", "--hyp", "h"]),
                      (check_single_speaker, ["--wav", "a.wav"]),
                      (analyze_similarity, ["--emb", "e", "--out_dir",
                                            str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert check_single_speaker.get_args(["--wav", "a.wav"]).device == "cuda"
    assert infer_diarization.get_args(
        ["--wav", "a.wav", "--out_dir", "o"]).device == "cuda"
    # asked for explicitly, the CPU works
    embed = build_embedding_fn(model, device="cpu")
    assert embed(torch.zeros((2, 8000))).shape == (2, 192)
    assert probe_ops.main(["--device", "cpu"]) == 0
