"""The port's mesh (``speaker3d_tpu_torch/parallel/mesh.py``) against the JAX
package's ``parallel/mesh.py`` on the tests' virtual CPU devices.

- ``make_mesh``: the grid of ranks equals the JAX mesh's grid of device
  ids over four devices for every shape, each rank's coordinates are its
  place in that grid, and the errors are the JAX ones.
- ``balanced_devices`` equals the JAX function on one node and takes each
  node's first ranks on several.
- The placements name the JAX shardings' axes, and ``shard`` gives each
  grid position the block that JAX lays on that device.
- ``init_multihost`` resolves each field as argument, then
  ``SPEAKER3D_*``, then torchrun's variables; with no coordinator it starts
  no process group; a configured coordinator that nobody serves raises, as
  does the card asked for where there is none.
- A world-1 ``gloo`` group: the SV train step on a 1 x 1 mesh over it
  equals the step without a mesh.
"""

import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from speaker3d_tpu.parallel import mesh as jmesh
from speaker3d_tpu_torch.parallel import mesh as tmesh
from speaker3d_tpu_torch.train import sv_train as tsv
from tests.torch_mesh_worker import _free_port
from tests.torch_threads import cap_torch_threads  # noqa: F401

SHAPES = ((None, 1), (None, 2), (None, 4), (2, 2), (1, 4), (4, 1), (1, 2),
          (3, 1), (1, 1))
ENV = ("SPEAKER3D_COORDINATOR_ADDRESS", "SPEAKER3D_NUM_PROCESSES",
       "SPEAKER3D_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
       "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def no_cluster_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_make_mesh_grid_and_coordinates_equal_jax(shape):
    data, model = shape
    want = jmesh.make_mesh(data, model, devices=jax.devices()[:4])
    got = tmesh.make_mesh(data, model, devices=range(4), device="cpu")
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    assert got.shape == dict(want.shape)
    assert got.axis_names == want.axis_names == ("data", "model")
    for rank in range(4):
        where = np.argwhere(ids == rank)
        coords = got.coords_of(rank)
        if not len(where):
            assert coords is None
            continue
        assert (coords["data"], coords["model"]) == tuple(where[0])
    # no process group: this process is rank 0 and its groups are None
    assert got.coords == got.coords_of(0)
    assert got.group("data") is got.group(("data", "model")) is None


@pytest.mark.parametrize("args", [dict(model=3), dict(data=3, model=2),
                                  dict(data=5), dict(data=2, model=3)],
                         ids=str)
def test_make_mesh_errors_equal_jax(args):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(devices=jax.devices()[:4], **args)
    with pytest.raises(ValueError) as got:
        tmesh.make_mesh(devices=range(4), device="cpu", **args)
    assert str(got.value) == str(want.value)


def test_make_mesh_runs_on_the_card_unless_asked():
    # one process with no group is a world of one
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.devices.tolist() == [[0]] and mesh.size == 1
    assert mesh.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh()


def test_balanced_devices(monkeypatch):
    # one node: the JAX function's result on one process
    for n in (1, 2, 4, 8):
        monkeypatch.setattr(tmesh, "_world", lambda: (0, 8))
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        want = [d.id for d in jmesh.balanced_devices(n)]
        assert tmesh.balanced_devices(n) == want == list(range(n))
    # two nodes of four: each node's first ranks
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert tmesh.balanced_devices(4) == [0, 1, 4, 5]
    assert tmesh.balanced_devices(8) == list(range(8))
    with pytest.raises(ValueError, match="3 mesh devices not divisible by "
                                         "2 processes"):
        tmesh.balanced_devices(3)
    with pytest.raises(ValueError, match="process 0 has 4 devices, needs 5"):
        tmesh.balanced_devices(10)
    # the JAX errors, as the JAX function words them
    with pytest.raises(ValueError, match="process 0 has 8 devices, needs 16"):
        jmesh.balanced_devices(16)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_placements_name_the_jax_shardings_axes(ndim):
    jm = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    tm = tmesh.make_mesh(2, 2, devices=range(4), device="cpu")
    assert tmesh.replicated(tm).spec == tuple(jmesh.replicated(jm).spec)
    assert (tmesh.data_sharded(tm, ndim).spec
            == tuple(jmesh.data_sharded(jm, ndim).spec))
    assert (tmesh.model_sharded(tm, ndim + 1).spec
            == tuple(jmesh.model_sharded(jm, ndim + 1).spec))


@pytest.mark.parametrize("spec", [("data",), ("model", None), (None, "model"),
                                  ("data", "model"), ()], ids=str)
def test_shard_takes_the_block_jax_lays_on_each_device(spec):
    jm = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    arr = jax.device_put(x, NamedSharding(jm, P(*spec)))
    blocks = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    tm = tmesh.make_mesh(2, 2, devices=range(4), device="cpu")
    for rank in range(4):
        tm.coords = tm.coords_of(rank)
        got = tmesh.shard(x, tmesh.Placement(tm, spec))
        np.testing.assert_array_equal(got.numpy(), blocks[rank])


def test_shard_refuses_an_uneven_split():
    tm = tmesh.make_mesh(2, 2, devices=range(4), device="cpu")
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        tmesh.shard(np.zeros((5, 2)), tmesh.data_sharded(tm))


def test_init_multihost_without_a_coordinator_is_a_noop(no_cluster_env,
                                                        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("init_process_group called")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    assert tmesh.init_multihost(device="cpu") is False
    # counts alone name no coordinator either
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("SPEAKER3D_PROCESS_ID", "1")
    assert tmesh.init_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_init_multihost_resolution_order(no_cluster_env, monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **k: calls.append(k))

    def resolved(*args):
        assert tmesh.init_multihost(*args, device="cpu") is True
        k = calls.pop()
        assert k["backend"] == "gloo"
        return k["init_method"], k["world_size"], k["rank"]

    # torchrun's variables
    for var, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29611"),
                   ("WORLD_SIZE", "4"), ("RANK", "2")):
        monkeypatch.setenv(var, v)
    assert resolved() == ("tcp://127.0.0.1:29611", 4, 2)
    # SPEAKER3D_* before them
    for var, v in (("SPEAKER3D_COORDINATOR_ADDRESS", "127.0.0.1:29612"),
                   ("SPEAKER3D_NUM_PROCESSES", "3"),
                   ("SPEAKER3D_PROCESS_ID", "1")):
        monkeypatch.setenv(var, v)
    assert resolved() == ("tcp://127.0.0.1:29612", 3, 1)
    # the arguments before both, each field on its own
    assert resolved("127.0.0.1:29613") == ("tcp://127.0.0.1:29613", 3, 1)
    assert resolved(None, 5, 4) == ("tcp://127.0.0.1:29612", 5, 4)
    # a coordinator without the counts
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="SPEAKER3D_NUM_PROCESSES"):
        tmesh.init_multihost("127.0.0.1:29614", device="cpu")
    assert not calls


def test_init_multihost_failures_propagate(no_cluster_env):
    # rank 1 of 2 against a coordinator nobody serves
    with pytest.raises(RuntimeError):
        tmesh.init_multihost(f"127.0.0.1:{_free_port()}", 2, 1, device="cpu",
                             timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()
    # the card where there is none: no fall-back to gloo on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0)
        assert not dist.is_initialized()


def test_world_1_group_step_equals_the_step_without_a_group(no_cluster_env):
    from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2

    rng = np.random.default_rng(0)
    batch = {"feats": torch.from_numpy(
        rng.standard_normal((4, 60, 80)).astype(np.float32)),
        "labels": torch.tensor([0, 2, 1, 2])}
    cfg = tsv.SVTrainConfig(num_classes=3, embedding_size=16,
                            step_per_epoch=4, warmup_epoch=1, max_lr=0.01)

    def run(mesh):
        torch.manual_seed(0)
        model = ERes2NetV2(num_blocks=(1, 1, 1, 1), m_channels=8,
                           embedding_size=16)
        state = tsv.init_sv_train_state(model, cfg, seed=1, device="cpu",
                                        mesh=mesh)
        state.step = 2
        step = tsv.make_sv_train_step(model, cfg, mesh=mesh)
        metrics = [step(state, batch) for _ in range(2)]
        return tsv.state_tree(state), metrics

    want, want_m = run(None)
    assert tmesh.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                                device="cpu")
    try:
        mesh = tmesh.make_mesh(device="cpu")
        assert mesh.group("model") is not None
        got, got_m = run(mesh)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got_m, want_m):
        for k in w:
            assert torch.equal(torch.as_tensor(g[k]), torch.as_tensor(w[k])), k
    for key in ("cls_w", "step"):
        np.testing.assert_array_equal(got[key], want[key])
    for k, v in want["model"].items():
        np.testing.assert_array_equal(got["model"][k], v, err_msg=k)
    for k, v in want["momentum"]["model"].items():
        np.testing.assert_array_equal(got["momentum"]["model"][k], v,
                                      err_msg=k)
