"""Build the port's native runtime (C++17) with g++ and no cmake.

Sources: ``runtime/src`` and ``runtime/bin`` (headers in
``runtime/include``). The binaries:

- ``make_fbank_feature``, ``read_and_describe_wav``, ``print_chunk_plan``:
  the host frontend alone;
- ``print_op_schema``: registers ``s3d::res2_block`` (``src/res2_op.cpp``)
  and prints its schema;
- ``extract_speaker_embedding``: the serving CLI, linked against libtorch
  (the ``aot`` engine, ``src/aoti_engine.cpp``) and, in a CUDA build,
  libtorch_cuda and the Res2 kernel's library that ``kernels/build.py``
  builds from ``csrc/res2_block.cu``;
- ``libs3d_bridge.so``: the ``bridge`` engine (``src/embedder.cpp``),
  linked against the interpreter's libpython, which the CLI loads only for
  that engine (``src/bridge.cpp``).

torch's headers and libraries, its ``_GLIBCXX_USE_CXX11_ABI`` and the
Python embedding flags come from the running interpreter. Each translation
unit compiles in a g++ process of its own, all at once, into
``speaker3d_tpu_torch/_build/runtime-<cpu|cuda>-<hash>/``; the hash covers
every source and header, the flags and the kernel library's name, so an
edit rebuilds and a stale binary is never run.

    python -m speaker3d_tpu_torch.runtime.build [--device cuda|cpu]

prints the directory. The default is a CUDA build (which needs nvcc and the
CUDA headers); ``--device cpu`` builds without CUDA, and its binaries run
``--device cpu`` only.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time

import torch

from speaker3d_tpu_torch.kernels import build as kernel_build

RUNTIME = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = kernel_build.BUILD_DIR
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")
CXX = os.environ.get("CXX", "g++")
# translation units -> the binaries that link them
OBJECTS = ("src/fbank.cpp", "src/wav.cpp", "src/res2_op.cpp",
           "src/aoti_engine.cpp", "src/embedder.cpp", "src/bridge.cpp",
           "bin/make_fbank_feature.cpp", "bin/read_and_describe_wav.cpp",
           "bin/print_chunk_plan.cpp", "bin/print_op_schema.cpp",
           "bin/extract_speaker_embedding.cpp")
FRONTEND = ("src/fbank.cpp", "src/wav.cpp")
BINARIES = {
    "make_fbank_feature": (("bin/make_fbank_feature.cpp", *FRONTEND), ()),
    "read_and_describe_wav": (("bin/read_and_describe_wav.cpp", *FRONTEND),
                              ()),
    "print_chunk_plan": (("bin/print_chunk_plan.cpp",), ()),
    "print_op_schema": (("bin/print_op_schema.cpp", "src/res2_op.cpp"),
                        ("torch",)),
    "extract_speaker_embedding": (
        ("bin/extract_speaker_embedding.cpp", *FRONTEND, "src/res2_op.cpp",
         "src/aoti_engine.cpp", "src/bridge.cpp"), ("torch", "dl")),
    "libs3d_bridge.so": (("src/embedder.cpp",), ("shared", "python")),
}


def openmp_cxx() -> str:
    """A host C++ compiler that links OpenMP (``-fopenmp``), which every
    AOTInductor package's link step asks for: $CXX, else ``g++`` on the
    PATH, else /usr/bin/g++(-N), the first whose libgomp.spec exists."""
    candidates = (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
                  *sorted(glob.glob("/usr/bin/g++-[0-9]*"), reverse=True))
    for cxx in dict.fromkeys(filter(None, candidates)):
        try:
            spec = subprocess.run([cxx, "-print-file-name=libgomp.spec"],
                                  capture_output=True, text=True,
                                  timeout=60).stdout.strip()
        except OSError:
            continue
        if os.path.isabs(spec) and os.path.isfile(spec):
            return cxx
    raise RuntimeError("no host C++ compiler links OpenMP (libgomp.spec): "
                       f"tried {[c for c in candidates if c]}")


def python_embeddable() -> bool:
    """Whether this interpreter ships a shared libpython to embed."""
    return bool(sysconfig.get_config_var("Py_ENABLE_SHARED"))


def _flags(cuda: bool) -> tuple:
    """(compile flags, {"torch": link flags, "python": link flags})."""
    tdir = os.path.dirname(torch.__file__)
    tinc, tlib = os.path.join(tdir, "include"), os.path.join(tdir, "lib")
    cflags = ["-std=c++17", "-O2", "-fPIC",
              f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
              "-I", os.path.join(RUNTIME, "include"), "-isystem", tinc,
              "-isystem", os.path.join(tinc, "torch", "csrc", "api", "include"),
              "-isystem", sysconfig.get_config_var("INCLUDEPY"),
              f'-DS3D_PYTHON_EXECUTABLE="{sys.executable}"']
    libs = ["torch", "torch_cpu", "c10"]
    if cuda:
        cflags += ["-DS3D_WITH_CUDA", "-isystem",
                   os.path.join(CUDA_HOME, "include")]
        libs += ["torch_cuda", "c10_cuda"]
    # no-as-needed: libtorch_cuda registers the CUDA kernels and the AOTI
    # runner when it loads, though no symbol of it is named
    # allow-shlib-undefined: libtorch_cuda's own dependencies (NCCL, cuDNN,
    # ...) are found at run time through its RPATH, which the link step
    # does not read (it may find an older system libnccl instead).
    # rdynamic: an AOTInductor package's model container resolves symbols
    # in the process's global scope, as in the Python interpreter, which
    # exports its own; without it the container's constructor crashed
    # (SIGSEGV) under torch 2.11
    torch_link = [f"-L{tlib}", f"-Wl,-rpath,{tlib}", "-Wl,--no-as-needed",
                  *(f"-l{name}" for name in libs), "-Wl,--as-needed",
                  "-Wl,--allow-shlib-undefined", "-rdynamic"]
    if cuda:
        kernel = kernel_build._target("res2_block")
        kdir, kname = os.path.split(kernel)
        torch_link += [f"-L{kdir}", f"-Wl,-rpath,{kdir}", f"-l:{kname}"]
    pylib = sysconfig.get_config_var("LIBDIR")
    cflags.append('-DS3D_LIBPYTHON="' + os.path.join(
        pylib, sysconfig.get_config_var("LDLIBRARY")) + '"')
    python_link = [f"-L{pylib}", f"-Wl,-rpath,{pylib}",
                   f"-lpython{sysconfig.get_config_var('LDVERSION')}",
                   *sysconfig.get_config_var("LIBS").split(),
                   *sysconfig.get_config_var("SYSLIBS").split()]
    return cflags, {"torch": torch_link, "python": python_link,
                    "dl": ["-ldl"], "shared": ["-shared"]}


def target(cuda: bool) -> str:
    """The build's directory: its name carries a hash of every source and
    header of the runtime, the flags and (CUDA) the kernel library's name."""
    cflags, link = _flags(cuda)
    digest = hashlib.sha256(" ".join(
        [CXX, *cflags, *(f for flags in link.values() for f in flags)]
    ).encode())
    for sub in ("include/s3d", "src", "bin"):
        for fn in sorted(os.listdir(os.path.join(RUNTIME, sub))):
            with open(os.path.join(RUNTIME, sub, fn), "rb") as f:
                digest.update(f"{sub}/{fn}".encode() + b"\0" + f.read())
    kind = "cuda" if cuda else "cpu"
    return os.path.join(BUILD_DIR, f"runtime-{kind}-{digest.hexdigest()[:16]}")


def _run_all(cmds: dict) -> None:
    """Run {name: argv} at once; raise naming every one that failed."""
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"[g++ {name}] rc={proc.returncode}\n{log}", flush=True)
            failed.append(name)
    if failed:
        raise RuntimeError(f"g++ failed for {failed}")


def build(cuda: bool = True) -> str:
    """Build the runtime (a CUDA build first builds the Res2 kernel's
    library) unless this hash is built; return its directory."""
    if cuda:
        kernel_build.build(["res2_block"])
    out = target(cuda)
    if os.path.isdir(out):
        return out
    cflags, link = _flags(cuda)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="runtime-tmp-", dir=BUILD_DIR)
    try:
        obj = {src: os.path.join(tmp, src.replace("/", "_") + ".o")
               for src in OBJECTS}
        _run_all({src: [CXX, *cflags, "-c", os.path.join(RUNTIME, src), "-o",
                        obj[src]] for src in OBJECTS})
        # without a shared libpython the bridge engine's library is left
        # out, and --engine bridge says that it cannot load it
        _run_all({name: [CXX, *(obj[s] for s in srcs), "-o",
                         os.path.join(tmp, name),
                         *(flag for kind in kinds for flag in link[kind])]
                  for name, (srcs, kinds) in BINARIES.items()
                  if "python" not in kinds or python_embeddable()})
        for o in obj.values():
            os.remove(o)
        try:
            os.rename(tmp, out)  # atomic: a reader never sees a partial build
        except OSError:
            if not os.path.isdir(out):  # not another process's same build
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: link libtorch_cuda and the Res2 kernel; cpu: "
                        "no CUDA")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    out = build(cuda=args.device == "cuda")
    print(f"runtime built in {time.perf_counter() - t0:.1f} s: {out}")


if __name__ == "__main__":
    main()
