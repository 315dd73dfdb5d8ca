"""The PyTorch package stands alone and defaults to the card.

- Every module of ``speaker3d_tpu_torch`` imports in a fresh interpreter in
  which ``jax`` and ``speaker3d_tpu`` cannot be imported.
- No module, and not ``chip_smoke.py`` nor the mesh tests' rank entry
  module ``tests/torch_mesh_worker.py``, names ``jax``/``flax``,
  ``speaker3d_tpu`` or ``sklearn`` in an import (AST scan), so no later
  slice reaches for the JAX package or for scikit-learn, which the card's
  machine lacks. The rank entry module also imports in a fresh
  interpreter with them blocked.
- Every module also imports with ``cv2`` blocked, and ``cv2`` is imported
  only inside the functions that read video frames, images or ONNX models
  (the video CLI's ``read_frames`` and two ONNX builders, the face
  detector trainer's JSONL batches, the ASD loader's ``load_visual``, and
  two functions of ``chip_smoke.py``: the MJPG video and the ASD corpus's
  jpg crops).
- Every module also imports with ``transformers`` blocked, which is imported
  only in the semantic CLI's ``--pretrained`` tokenizer.
- The entry points raise without a CUDA device unless the caller passes
  ``device="cpu"``: nothing falls back to the CPU on its own.
- The port's native runtime (``speaker3d_tpu_torch/runtime``) includes
  nothing from the root ``runtime/`` tree (only its own ``s3d/`` headers,
  the standard library, torch's, CUDA's and Python's) and names no module
  of the JAX package.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import speaker3d_tpu_torch
from tests.torch_threads import cap_torch_threads  # noqa: F401

PKG_DIR = os.path.dirname(speaker3d_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "speaker3d_tpu", "sklearn")
# (file relative to the repo root, function) where cv2 may be imported
CV2_FUNCTIONS = {
    ("speaker3d_tpu_torch/cli/infer_diarization_video.py", "read_frames"),
    ("speaker3d_tpu_torch/cli/infer_diarization_video.py",
     "build_face_detector"),
    ("speaker3d_tpu_torch/cli/infer_diarization_video.py",
     "build_face_embedder"),
    ("speaker3d_tpu_torch/cli/train_face_detector.py", "make_batch"),
    ("speaker3d_tpu_torch/data/dataset_asd.py", "load_visual"),
    ("chip_smoke.py", "_video_cv2"),
    ("chip_smoke.py", "asd_corpus"),
}
TRANSFORMERS_FUNCTIONS = {
    ("speaker3d_tpu_torch/cli/semantic.py", "pretrained_tokenizer"),
}


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
                 "models.xvector", "models.classifier", "utils.config",
                 "utils.builder", "utils.misc", "utils.checkpoint",
                 "utils.preemption", "utils.profiling", "train.schedulers",
                 "train.losses", "train.sv_train", "data.resample",
                 "data.augmentation", "data.processors", "data.dataset",
                 "data.prefetch", "cli.train", "models.fsmn_vad",
                 "models.segmentation", "diar.overlap", "diar.dnn_vad",
                 "diar.dnn_seg", "data.dataset_vad", "data.dataset_seg",
                 "train.vad_train", "train.seg_train", "cli.train_vad",
                 "cli.train_segmentation", "data.processor_para",
                 "models.sanm", "asr.ctc", "diar.transcribe",
                 "cli.transcribe_diarization", "cli.train_asr_ctc",
                 "cli.predict_label", "diar.gmm", "diar.boundaries",
                 "cli.detect_boundaries", "ops.melspec", "models.ssl_heads",
                 "train.ssl_losses", "train.ssl_train", "data.dataset_ssl",
                 "cli.train_ssl", "cli.extract_ssl", "cli.infer_sv_ssl",
                 "ops.mfcc", "diar.video", "data.synthetic_faces",
                 "models.face_detector", "models.talknet",
                 "cli.train_face_detector", "cli.infer_diarization_video",
                 "data.dataset_asd", "train.asd_train", "cli.train_asd",
                 "cli.run_diarization_simple", "cli.run_diarization_on_dir",
                 "cli.run_diarization_speech_estimate", "cli.train_para",
                 "compat.funasr_convert", "semantic.bert",
                 "data.semantic_prep", "cli.semantic",
                 "cli.export_speaker_embedding", "runtime_bridge",
                 "runtime.build", "parallel.mesh"):
        assert f"speaker3d_tpu_torch.{name}" in mods, name


def test_every_module_imports_without_jax():
    """... and without cv2 or transformers."""
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN + ('cv2', 'transformers')!r}:\n"
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


def test_mesh_worker_imports_without_jax():
    """The entry module of the mesh tests' ranks, and the modules its
    scenarios reach."""
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import tests.torch_mesh_worker\n"
        "import speaker3d_tpu_torch.eval.embedding, "
        "speaker3d_tpu_torch.eval.scoring, speaker3d_tpu_torch.train.sv_train\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _sources():
    for dirpath, _, files in os.walk(PKG_DIR):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tests", "torch_mesh_worker.py")


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


def _imports_by_function(module: str, allowed: set) -> set:
    """The (file, function) pairs that import ``module``; each must be in
    ``allowed``."""
    found = set()
    for path in _sources():
        rel = os.path.relpath(path, ROOT)
        with open(path) as f:
            tree = ast.parse(f.read(), path)

        def visit(node, func):
            for child in ast.iter_child_nodes(node):
                names = []
                if isinstance(child, ast.Import):
                    names = [a.name for a in child.names]
                elif isinstance(child, ast.ImportFrom) and child.module:
                    names = [child.module]
                if any(n.split(".")[0] == module for n in names):
                    assert (rel, func) in allowed, (rel, func, child.lineno)
                    found.add((rel, func))
                inner = (child.name if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)
                visit(child, inner)

        visit(tree, None)
    return found


def test_cv2_only_inside_the_named_functions():
    assert _imports_by_function("cv2", CV2_FUNCTIONS) == CV2_FUNCTIONS


def test_transformers_only_inside_the_tokenizer():
    assert (_imports_by_function("transformers", TRANSFORMERS_FUNCTIONS)
            == TRANSFORMERS_FUNCTIONS)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a CUDA card")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from speaker3d_tpu_torch.cli import (
        analyze_similarity, check_single_speaker, compute_der,
        compute_score_metrics, detect_boundaries, extract, extract_ssl,
        infer_diarization, infer_diarization_video, infer_sv, infer_sv_batch,
        infer_sv_ssl, serve_embedding, train, train_face_detector,
        train_segmentation, train_ssl, train_vad)
    from speaker3d_tpu_torch.data.prefetch import device_prefetch
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
    from speaker3d_tpu_torch.cli import semantic, train_para
    from speaker3d_tpu_torch.semantic.bert import build_model
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("sequence", hidden_size=32, num_hidden_layers=1,
                    num_attention_heads=2)
    for task in ("dialogue", "turn"):
        with pytest.raises(RuntimeError, match="CUDA"):
            semantic.main([task, "--train", "t", "--eval", "e",
                           "--exp_dir", str(tmp_path / "sem")])
    assert semantic.get_args(["turn", "--train", "t", "--eval", "e",
                              "--exp_dir", "x"]).device == "cuda"
    for trainer in (train, train_vad, train_segmentation, train_ssl,
                    train_face_detector, train_para):
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer.main(["--config", "c.yaml"])
    for cli, argv in ((extract_ssl, ["--exp_dir", "x", "--data", "s",
                                     "--out_dir", str(tmp_path)]),
                      (infer_sv_ssl, ["--exp_dir", "x", "--wavs", "a.wav"]),
                      (detect_boundaries, ["--emb", "e", "--num_speakers",
                                           "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    from speaker3d_tpu_torch.diar.dnn_seg import load_segmentation_exp
    from speaker3d_tpu_torch.diar.dnn_vad import load_vad_exp
    for load in (load_vad_exp, load_segmentation_exp):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_prefetch(iter([])))
    with pytest.raises(RuntimeError, match="CUDA"):
        infer_diarization_video.main(["--video", "v.avi", "--wav", "a.wav",
                                      "--out_dir", str(tmp_path)])
    assert infer_diarization_video.get_args(
        ["--video", "v", "--out_dir", "o"]).device == "cuda"
    from speaker3d_tpu_torch.diar.video import make_talknet_asd_scorer
    from speaker3d_tpu_torch.models.face_detector import load_face_detector_exp
    with pytest.raises(RuntimeError, match="CUDA"):
        load_face_detector_exp(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_talknet_asd_scorer(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_embedding.main(["--model_id", "m"])
    for cli, argv in ((compute_der, ["--ref", "r", "--hyp", "h"]),
                      (check_single_speaker, ["--wav", "a.wav"]),
                      (analyze_similarity, ["--emb", "e", "--out_dir",
                                            str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert check_single_speaker.get_args(["--wav", "a.wav"]).device == "cuda"
    from speaker3d_tpu_torch.cli import (
        run_diarization_on_dir, run_diarization_simple,
        run_diarization_speech_estimate, train_asd)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_asd.main(["--train_csv", "t", "--val_csv", "v", "--audio_dir",
                        "a", "--video_dir", "v", "--exp_dir",
                        str(tmp_path / "asd")])
    assert train_asd.get_args(["--train_csv", "t", "--val_csv", "v",
                               "--audio_dir", "a", "--video_dir", "v",
                               "--exp_dir", "e"]).device == "cuda"
    (tmp_path / "x_speech_estimate.wav").write_bytes(b"")
    for driver, argv in ((run_diarization_simple, ["--out_dir",
                                                   str(tmp_path / "o")]),
                         (run_diarization_on_dir, []),
                         (run_diarization_speech_estimate, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            driver.main(["--src_dir", str(tmp_path)] + argv)
    assert infer_diarization.get_args(
        ["--wav", "a.wav", "--out_dir", "o"]).device == "cuda"
    # asked for explicitly, the CPU works
    embed = build_embedding_fn(model, device="cpu")
    assert embed(torch.zeros((2, 8000))).shape == (2, 192)
    assert probe_ops.main(["--device", "cpu"]) == 0


def test_export_and_the_bridge_default_to_cuda(no_cuda, tmp_path):
    from speaker3d_tpu_torch import runtime_bridge
    from speaker3d_tpu_torch.cli import export_speaker_embedding
    from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2

    with pytest.raises(RuntimeError, match="CUDA"):
        runtime_bridge.init(str(tmp_path / "exp"))
    assert export_speaker_embedding.get_args(["--out", "m.pt2"]).device == \
        "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        export_speaker_embedding.main(["--model_id", "x", "--out", "m.pt2"])
    model = ERes2NetV2(num_blocks=(1, 1, 1, 1), m_channels=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_speaker_embedding.export_model(model, frames=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_speaker_embedding.export_aot_artifact(model, str(tmp_path))


RUNTIME_DIR = os.path.join(PKG_DIR, "runtime")
# the headers the port's C++ may include besides its own s3d/ ones
SYSTEM_INCLUDES = ("Python.h", "ATen/", "c10/", "torch/")


def test_native_runtime_stands_alone():
    """Every #include names the port's own s3d/ headers (each present
    under runtime/include), a <system> header or torch's, CUDA's or
    Python's; no source names the JAX package's bridge or PJRT; the build
    puts no root runtime/ directory on the include path."""
    from speaker3d_tpu_torch.runtime import build

    own = set(os.listdir(os.path.join(RUNTIME_DIR, "include", "s3d")))
    sources = [os.path.join(d, f) for d, _, fs in os.walk(RUNTIME_DIR)
               for f in fs if f.endswith((".cpp", ".h"))]
    assert len(sources) >= 13
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert "speaker3d_tpu.runtime_bridge" not in text, path
        assert "pjrt_c_api" not in text and "PjrtEngine" not in text, path
        for line in text.splitlines():
            if not line.startswith("#include"):
                continue
            name = line.split(None, 1)[1].strip()
            if name.startswith('"s3d/'):
                assert name[len('"s3d/'):-1] in own, (path, line)
            else:
                assert name.startswith("<"), (path, line)
                assert ".." not in name, (path, line)
    root_runtime = os.path.join(ROOT, "runtime")
    for cuda in (False, True):
        cflags, link = build._flags(cuda)
        assert not any(root_runtime in flag.replace(RUNTIME_DIR, "")
                       for flag in cflags + link["torch"] + link["python"])
