"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` is compiled into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The build runs at first use, from the repository's sources only, into
``speaker3d_tpu_torch/_build/`` (listed in ``.gitignore``). The file name
carries a hash of the source, the headers in ``csrc/`` and the flags, so an
edited source or header is rebuilt and a stale library is never loaded. ``build()`` starts one ``nvcc`` per
source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = {"fbank": "fbank.cu", "res2_block": "res2_block.cu",
           "probe_ops": "probe_ops.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on the GPU machine")
    return path


def _target(name: str) -> str:
    """The library's path: its name carries a hash of the source, of every
    header in ``csrc/`` (a source may include any of them) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, fn), "rb") as f:
            digest.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process each, in parallel. Returns {name: seconds} of this call's
    builds. ``verbose`` adds ``-Xptxas -v`` and prints nvcc's output
    (registers, shared memory, spills per kernel)."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if verbose or proc.returncode:
            print(f"[nvcc {name}] rc={proc.returncode}\n{log}", flush=True)
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``name``, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name))
            lib.s3d_errstr.restype = ctypes.c_char_p
            lib.s3d_errstr.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (every entry
    point returns ``cudaGetLastError()`` right after its launch)."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.s3d_errstr(rc).decode()})")
