"""The port's semantic train step against the JAX package's
``semantic/bert.py::make_semantic_train_step``.

Three train steps from one state and one set of batches match the JAX step
on a one-device CPU mesh (the JAX CLI's ``make_mesh(model=1)`` spans every
device, where the token loss becomes a mean of per-shard means; the port
computes the one-device step): the lr bit-equal, the loss at 1e-4 of its
size, the predictions equal, every parameter at atol 1e-4 (the steps move
each by up to ~1e-2). The tiny BERT, the batches and the conversions:
``tests/semantic_common.py``.
"""

import jax
import numpy as np
import pytest

from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu.semantic import bert as jbert
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.semantic import bert as tbert
from speaker3d_tpu_torch.train.vad_train import init_adam_train_state
from tests.semantic_common import (
    TASKS, batch, jax_models as build_jax_models, port, torch_batch)
from tests.torch_threads import cap_torch_threads  # noqa: F401

TOL = 1e-4
# a schedule whose first three steps warm up and decay: lr 2.5e-3, 5e-3, 5e-3
# times 1, 0.9, 0.8
CFG = jbert.SemanticTrainConfig(lr=5e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def jax_models():
    return build_jax_models()


@pytest.mark.parametrize("task,token_level", TASKS)
def test_three_train_steps_match_the_one_device_jax_step(jax_models, task,
                                                         token_level):
    jm = jax_models[task]
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jstate = jbert.init_semantic_state(jm, mesh)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
    jstep = jbert.make_semantic_train_step(jm, CFG, mesh, host["params"],
                                           token_level)
    model = port(task, host["params"])
    state = init_adam_train_state(model, "cpu")
    step = tbert.make_semantic_train_step(model, tbert.SemanticTrainConfig(
        *CFG), token_level)
    rng = np.random.default_rng(5)
    for i in range(3):
        b = batch(rng, token_level)
        jstate, jm_out = jstep(jstate, b)
        out = step(state, torch_batch(b))
        want_loss = float(jm_out["loss"])
        assert abs(float(out["loss"]) - want_loss) <= TOL * abs(want_loss), i
        assert np.float32(out["lr"]) == np.asarray(jm_out["lr"]), i
        np.testing.assert_array_equal(out["preds"].numpy(),
                                      np.asarray(jm_out["preds"]))
    assert state.step == int(jstate["step"]) == 3
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
    want = state_dict_from_flax({"params": host["params"]})
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, val in got.items():
        np.testing.assert_allclose(val.numpy(), want[key].numpy(), rtol=0,
                                   atol=TOL, err_msg=key)
