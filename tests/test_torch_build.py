"""The port's kernel build names each library by what it is built from.

``kernels/build.py::_target`` puts a hash of the source, of every header in
``csrc/`` and of the nvcc flags into the library's file name, so an edited
source or header is rebuilt and a stale library is never loaded. Checked on
a scratch ``csrc/`` (no nvcc needed).
"""

import os

import pytest

from speaker3d_tpu_torch.kernels import build
from tests.torch_threads import cap_torch_threads  # noqa: F401


@pytest.fixture
def scratch_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\nint k() { return H; }\n')
    (csrc / "h.cuh").write_text("#define H 1\n")
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "SOURCES", {"k": "k.cu"})
    return csrc


@pytest.mark.parametrize("edit", ["header", "source", "new header", "flags"])
def test_target_changes_with_what_the_library_is_built_from(
        scratch_csrc, monkeypatch, edit):
    before = build._target("k")
    assert os.path.dirname(before) == build.BUILD_DIR
    if edit == "header":
        (scratch_csrc / "h.cuh").write_text("#define H 2\n")
    elif edit == "source":
        (scratch_csrc / "k.cu").write_text('#include "h.cuh"\nint k() { return -H; }\n')
    elif edit == "new header":
        (scratch_csrc / "g.cuh").write_text("#define G 1\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build._target("k") != before


def test_target_ignores_what_no_source_can_include(scratch_csrc):
    before = build._target("k")
    (scratch_csrc / "notes.txt").write_text("not a header\n")
    assert build._target("k") == before


def test_every_kernel_source_and_header_is_in_the_package():
    names = os.listdir(build.CSRC)
    assert set(build.SOURCES.values()) <= set(names)
    assert "tf32_mma.cuh" in names  # included by fbank.cu and res2_block.cu
    targets = {build._target(name) for name in build.SOURCES}
    assert len(targets) == len(build.SOURCES)
