"""SSL experiments across the two packages' trainers, at
``test_torch_ssl_cli.py``'s toy config: the port trains RDINO for one epoch
with ``--device cpu``, the JAX trainer resumes the port's experiment for a
second, the port's ``extract_ssl`` on the JAX-written checkpoint gives the
JAX package's embeddings within 1e-5 of their largest magnitude, and the
port's trainer resumes the JAX-written checkpoint for a third epoch.
"""

import pytest

from speaker3d_tpu.cli import train_ssl as jtrain
from speaker3d_tpu_torch.cli import train_ssl
from tests.test_torch_ssl_cli import (
    _ckpts, _run, assert_same, extract_both, make_experiment)
from tests.torch_threads import cap_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    out = make_experiment(tmp_path_factory)
    out["jax_epoch2"] = _run(jtrain.main, ["--config", out["cfg"],
                                           "--variant", "rdino",
                                           "--epochs=2"])
    out["emb2"] = extract_both(out, "e2")
    out["epoch3"] = _run(train_ssl.main, ["--config", out["cfg"],
                                          "--variant", "rdino", "--device",
                                          "cpu", "--epochs=3"])
    return out


def test_the_jax_trainer_resumes_the_ports_experiment(crossed):
    assert "recovered from epoch 1" in crossed["jax_epoch2"]
    assert "epoch 2: {" in crossed["jax_epoch2"]


def test_extract_ssl_reads_the_jax_trainers_checkpoint(crossed):
    got, want = crossed["emb2"]
    assert_same(got, want)


def test_the_ports_trainer_resumes_the_jax_trainers_checkpoint(crossed):
    assert "recovered from epoch 2" in crossed["epoch3"]
    assert _ckpts(crossed["exp"]) == [f"CKPT-EPOCH-{i}-00" for i in (1, 2, 3)]
