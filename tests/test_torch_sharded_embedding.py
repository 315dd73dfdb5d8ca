"""``build_sharded_embedding_fn`` and ``pairwise_cosine_device(mesh=...)``
of the port on four ``gloo`` ranks against the JAX functions on four
virtual CPU devices.

One module fixture starts the four ranks once (``tests/torch_mesh_worker.py``,
which imports no JAX). On the meshes (data=4, model=1) and (2, 2) each rank
embeds its rows of one seeded batch of eight 1 s waveforms with a small
ERes2NetV2 from the same converted JAX weights (on the CPU the plain fbank
and the plain Res2 block; on a card K1 and K2), and every rank gets the whole
batch: held against the JAX function at 1e-5 of the embeddings' scale. The
affinity of 37 seeded embeddings (not a multiple of the data axis, so the
rows are padded) is held against the JAX function at 1e-6.
"""

import jax
import numpy as np
import pytest

from speaker3d_tpu.eval.embedding import (
    build_sharded_embedding_fn as jax_sharded_embedding_fn)
from speaker3d_tpu.eval.scoring import (
    pairwise_cosine_device as jax_pairwise_cosine)
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tests.test_torch_eres2netv2 import assert_close_scaled, jax_variables
from tests.torch_mesh_worker import run_ranks
from tests.torch_threads import cap_torch_threads  # noqa: F401

SMALL = dict(num_blocks=(1, 1, 1, 1), m_channels=8, feat_dim=80,
             embedding_size=32)
MESHES = ((4, 1), (2, 2))
EMB_TOL = 1e-5
AFF_TOL = 1e-6


def _inputs():
    rng = np.random.default_rng(11)
    t = np.arange(16000) / 16000
    f0 = rng.uniform(100, 400, (8, 1))
    wavs = (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.3 * rng.standard_normal((8, 16000))).astype(np.float32)
    emb = rng.standard_normal((37, 24)).astype(np.float32)
    emb[5] = 0.0  # a zero row: the 1e-12 floor of the norm
    return wavs, emb


@pytest.fixture(scope="module")
def variables():
    return jax_variables(JaxERes2NetV2(**SMALL))


@pytest.fixture(scope="module")
def port_side(variables, tmp_path_factory):
    wavs, emb = _inputs()
    inp = {"meshes": MESHES, "small": SMALL, "variables": variables,
           "wavs": wavs, "emb": emb}
    return run_ranks("embed", inp, str(tmp_path_factory.mktemp("embed")))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_embedding_matches_jax(port_side, variables, shape):
    wavs, _ = _inputs()
    mesh = jax_make_mesh(*shape, devices=jax.devices()[:4])
    want = np.asarray(jax_sharded_embedding_fn(
        JaxERes2NetV2(**SMALL), variables, mesh)(wavs))
    got = port_side[shape]["emb"]
    assert got.shape == want.shape == (8, 32) and got.dtype == np.float32
    assert_close_scaled(got, want, EMB_TOL)
    # the rows differ from each other: the gather kept their order
    assert np.abs(got[0] - got[1]).max() > 1e-3


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_affinity_matches_jax(port_side, shape):
    _, emb = _inputs()
    mesh = jax_make_mesh(*shape, devices=jax.devices()[:4])
    want = jax_pairwise_cosine(emb, mesh=mesh)
    got = port_side[shape]["aff"]
    assert got.shape == want.shape == (37, 37) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=AFF_TOL)
