"""The port's list, YAML and JSON helpers (utils/fileio.py) against the JAX
package's ``speaker3d_tpu/utils/fileio.py`` on temporary files: each reads
what the other writes, and both read a file to the same value."""

import pytest

from speaker3d_tpu.utils import fileio as jax_io
from speaker3d_tpu_torch.utils import fileio as port_io
from tests.torch_threads import cap_torch_threads  # noqa: F401

SCP = {"utt1": "/data/a b/utt1.wav", "utt2": "rel/utt2.wav", "u3": "x"}
JSON = {"name": "会议", "segments": [[0.0, 1.5, "spk0"], [1.5, 3.25, "spk1"]],
        "n": 2, "ok": True, "none": None}


@pytest.mark.parametrize("writer,reader", [(jax_io, port_io),
                                           (port_io, jax_io)])
def test_wav_scp_and_utt2spk_round_trip(tmp_path, writer, reader):
    path, ref = tmp_path / "wav.scp", tmp_path / "ref.scp"
    writer.write_wav_scp(path, SCP)
    jax_io.write_wav_scp(ref, SCP)
    assert path.read_text() == ref.read_text()
    for load in ("load_wav_scp", "load_utt2spk"):
        assert getattr(reader, load)(path) == SCP
        assert getattr(port_io, load)(path) == getattr(jax_io, load)(path)


@pytest.mark.parametrize("writer,reader", [(jax_io, port_io),
                                           (port_io, jax_io)])
def test_json_round_trip(tmp_path, writer, reader):
    path = tmp_path / "out.json"
    writer.write_json_file(path, JSON)
    assert reader.load_json_file(path) == JSON
    ref = tmp_path / "ref.json"
    jax_io.write_json_file(ref, JSON)
    assert path.read_bytes() == ref.read_bytes()


def test_write_json_file_refuses_another_suffix(tmp_path):
    with pytest.raises(ValueError, match="json"):
        port_io.write_json_file(tmp_path / "out.txt", JSON)
    with pytest.raises(AssertionError):
        jax_io.write_json_file(tmp_path / "out.txt", JSON)


def test_yaml_and_data_list_match(tmp_path):
    yml = tmp_path / "c.yaml"
    yml.write_text("a: 1\nb: [x, 2.5]\nc:\n  d: null\n")
    assert port_io.load_yaml(yml) == jax_io.load_yaml(yml) == {
        "a": 1, "b": ["x", 2.5], "c": {"d": None}}
    lst = tmp_path / "list.txt"
    lst.write_text("  first  \nsecond\n\nlast")
    assert port_io.load_data_list(lst) == jax_io.load_data_list(lst) == {
        0: "first", 1: "second", 2: "", 3: "last"}
