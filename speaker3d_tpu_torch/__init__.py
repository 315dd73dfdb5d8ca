"""PyTorch/CUDA port of speaker3d_tpu for one NVIDIA H100.

The package mirrors the JAX package's module paths (``ops/fbank.py``,
``models/eres2netv2.py``, ``diar/pipeline.py``, ...) so that each module
has an obvious counterpart. It imports ``torch``, ``numpy`` and ``scipy``
only; it never imports ``jax`` or ``speaker3d_tpu``.

Entry points (``eval.embedding.build_embedding_fn``,
``diar.pipeline.DiarizationPipeline``, ``cli.infer_diarization``) run on the
CUDA device unless the caller passes ``device="cpu"``; without a CUDA
device and without an explicit ``cpu`` they raise.

The two hand-written CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``kernels/build.py``).
"""
