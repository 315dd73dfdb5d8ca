"""The port's SV train step on a ('data', 'model') mesh of four ``gloo``
ranks against the JAX ``make_sv_train_step`` on four virtual CPU devices.

One module fixture starts the four ranks once (``tests/torch_mesh_worker.py``,
which imports no JAX). Each runs the port's step at (data=2, model=2) and
(data=1, model=4) from the same converted weights and the JAX state's global
``cls_w``, three steps of the same seeded global batches (B = 8) of the JAX
fbank's features. ``NUM_CLASSES = 7`` over two or four class shards pads one
class column, which both steps mask. Both steps run in float64 (the JAX step
under ``jax.enable_x64``): in float32 this small random model's three steps
turn rounding into differences of up to 1e-3 in some weights on some
batches even on one device (a branch of the margin or a ReLU flips), so
float32 would test the batches, not the mesh. Held at
``tests/test_torch_sv_train.py``'s ``TOL`` and schedule: the loss, accuracy,
lr and margin of each step; the parameters, BatchNorm statistics, gathered
``cls_w`` and the SGD buffers (each at ``TOL`` of its own scale) after three
steps. The vocab-parallel loss's values and cosine gradients
on the (1, 4) mesh are held against the JAX loss under ``shard_map`` at
1e-5, and against the port's unsharded loss. At (1, 4) every rank sees the
whole batch, so the step equals the port's one-process step; at (2, 2) each
data row's BatchNorm sees its own four rows, in both packages. Rank 0's
checkpoint (the JAX ``train_state`` layout) resumes in one process and in
the JAX trainer. The trainer CLI on four ranks is
``tests/test_torch_train_cli_mesh.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu.ops.fbank import FbankConfig as JaxFbankConfig
from speaker3d_tpu.ops.fbank import KaldiFbank as JaxKaldiFbank
from speaker3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from speaker3d_tpu.train import sv_train as jsv
from speaker3d_tpu.train.losses import (
    sharded_arc_margin_loss as jax_sharded_loss)
from speaker3d_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
from speaker3d_tpu_torch.train import sv_train as tsv
from speaker3d_tpu_torch.train.losses import arc_margin_loss
from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
from speaker3d_tpu_torch.utils.threads import cpu_threads
from tests.test_torch_eres2netv2 import jax_variables
from tests.torch_mesh_worker import THREADS, run_ranks
from tests.torch_threads import cap_torch_threads  # noqa: F401

SMALL = dict(num_blocks=(1, 1, 1, 1), m_channels=8, feat_dim=80,
             embedding_size=32)
NUM_CLASSES = 7
# tests/test_torch_sv_train.py's schedule (that file explains the small lr)
SCHED = dict(num_classes=NUM_CLASSES, embedding_size=32, step_per_epoch=10,
             warmup_epoch=5, fix_epoch=12, increase_start_epoch=1,
             margin_fix_epoch=8, final_margin=0.3, max_lr=0.001)
START = 20
TOL = 1e-4
LOSS_TOL = 1e-5
MESHES = ((2, 2), (1, 4))
GLOBAL_B = 8


def _batches(n=3, b=GLOBAL_B, samples=8000, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    t = np.arange(samples) / 16000
    for _ in range(n):
        f0 = rng.uniform(100, 400, (b, 1))
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.3 * rng.standard_normal((b, samples)))
        pcm = np.round(np.clip(wav, -1, 1 - 1 / 32768) * 32768) / 32768
        out.append({"wavs": pcm.astype(np.float32),
                    "labels": rng.integers(0, NUM_CLASSES, b).astype(np.int32)})
    return out


def _loss_case(seed=4):
    rng = np.random.default_rng(seed)
    return {"cos": rng.uniform(-1, 1, (GLOBAL_B, 8)).astype(np.float32),
            "labels": rng.integers(0, 8, GLOBAL_B).astype(np.int32),
            "margin": 0.2}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda v: v.astype(np.float64) if v.dtype == np.float32 else v, tree)


def _feature_batches(**kw):
    """``_batches`` through the JAX fbank, in float64."""
    fbank = JaxKaldiFbank(JaxFbankConfig(), mean_norm=True)
    return [{"feats": np.asarray(fbank(b["wavs"])).astype(np.float64),
             "labels": b["labels"]} for b in _batches(**kw)]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX step in float64 on each mesh over four devices: its start
    state, three steps' metrics and final state, the compiled step and
    mesh."""
    jmodel = JaxERes2NetV2(**SMALL)
    variables = jax_variables(jmodel)
    cfg = jsv.SVTrainConfig(**SCHED)
    batches = _feature_batches()
    out = {}
    for shape in MESHES:
        mesh = jax_make_mesh(*shape, devices=jax.devices()[:4])
        state = jsv.init_sv_train_state(
            jax.random.PRNGKey(0), jmodel, np.zeros((1, 48, 80), np.float32),
            cfg, mesh, backbone_variables=variables)
        host = _f64(_host(state))
        host["step"] = np.asarray(START, np.int32)
        with jax.enable_x64(True):
            step = jsv.make_sv_train_step(jmodel, cfg, mesh, host)
            st = jax.device_put(host, jsv.state_shardings(host, mesh))
            metrics = []
            for batch in batches:
                st, m = step(st, batch)
                metrics.append({k: float(v) for k, v in m.items()})
            final = _host(st)
        assert final["cls_w"].dtype == np.float64
        out[shape] = {"start": host, "metrics": metrics, "final": final,
                      "step": step, "mesh": mesh}
    return out


@pytest.fixture(scope="module")
def jax_loss():
    case = _loss_case()
    mesh = jax_make_mesh(1, 4, devices=jax.devices()[:4])
    c_local = case["cos"].shape[1] // 4
    labels = jnp.asarray(case["labels"])

    def body(c):
        offset = jax.lax.axis_index("model") * c_local

        def total(c):
            ce = jax_sharded_loss(c, labels, offset, case["margin"])
            return jnp.sum(ce) / (c.shape[0] * 4), ce

        (_, ce), grad = jax.value_and_grad(total, has_aux=True)(c)
        return ce, grad

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(None, "model"),),
                               out_specs=(P(), P(None, "model")),
                               check_vma=False))
    ce, grad = fn(case["cos"])
    return np.asarray(ce), np.asarray(grad)


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """The four ranks, started once: both meshes' steps and the loss."""
    start = jax_side[MESHES[0]]["start"]
    for shape in MESHES[1:]:
        np.testing.assert_array_equal(jax_side[shape]["start"]["cls_w"],
                                      start["cls_w"])
    inp = {"meshes": MESHES, "small": SMALL, "sched": SCHED,
           "params": start["params"], "batch_stats": start["batch_stats"],
           "cls_w": start["cls_w"], "step": START,
           "batches": _feature_batches(),
           "loss": _loss_case()}
    out_dir = str(tmp_path_factory.mktemp("sv_sharded"))
    return run_ranks("sv_train", inp, out_dir), out_dir


def _one_process(start, batches):
    """The port's float64 step with no mesh on the global batches (the
    first NUM_CLASSES rows of ``cls_w``), at the ranks' thread count."""
    model = ERes2NetV2(**SMALL).double()
    model.load_state_dict(state_dict_from_flax(
        {"params": start["params"], "batch_stats": start["batch_stats"]}),
        strict=True)
    cfg = tsv.SVTrainConfig(**SCHED)
    state = tsv.init_sv_train_state(
        model, cfg, device="cpu",
        cls_w=torch.from_numpy(start["cls_w"][:NUM_CLASSES]))
    state.step = START
    step = tsv.make_sv_train_step(model, cfg)
    metrics = []
    with cpu_threads(THREADS):
        for b in batches:
            m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _flax_sd(tree):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    ).items() if not k.endswith("num_batches_tracked")}


def _mom_sd(tree):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        {"params": tree["momentum"]["params"]}).items()}


def _assert_trees_match(got, want, rows=None, tol=TOL):
    """Parameters, BatchNorm statistics and ``cls_w`` at ``tol``; each SGD
    buffer at ``tol`` of its scale. ``rows``: the classes."""
    g_sd, w_sd = _flax_sd(got), _flax_sd(want)
    assert sorted(g_sd) == sorted(w_sd)
    for k, v in w_sd.items():
        np.testing.assert_allclose(g_sd[k], v, rtol=0, atol=tol, err_msg=k)
    rows = slice(rows)
    np.testing.assert_allclose(got["cls_w"][rows], want["cls_w"][rows],
                               rtol=0, atol=tol)
    g_m, w_m = _mom_sd(got), _mom_sd(want)
    g_m["cls_w"] = got["momentum"]["cls_w"][rows]
    w_m["cls_w"] = want["momentum"]["cls_w"][rows]
    assert max(float(np.abs(v).max()) for v in w_m.values()) > 1.0
    for k, v in w_m.items():
        np.testing.assert_allclose(
            g_m[k], v, rtol=0, atol=tol * max(1.0, float(np.abs(v).max())),
            err_msg=k)


def test_sharded_arc_margin_loss_matches_jax(port_side, jax_loss):
    got = port_side[0]["loss"]
    ce, grad = jax_loss
    np.testing.assert_allclose(got["ce"], ce, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(got["grad"], grad, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    # the gathered shard gradients of sum(ce) / (B * n_model) are the true
    # partials of the mean cross entropy over all classes
    case = _loss_case()
    cos = torch.from_numpy(case["cos"]).requires_grad_(True)
    mean = arc_margin_loss(cos, torch.from_numpy(case["labels"]),
                           case["margin"])
    (want,) = torch.autograd.grad(mean, [cos])
    np.testing.assert_allclose(got["grad"], want.numpy(), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert np.abs(grad).max() > 1e-2


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_three_sharded_steps_match_the_jax_step(port_side, jax_side, shape):
    got, want = port_side[0][shape], jax_side[shape]
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g.keys() == w.keys() == {"loss", "acc", "lr", "margin"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    tree = got["tree"]
    assert int(tree["step"]) == START + 3 == int(want["final"]["step"])
    # the global classifier holds the padded class row, as JAX's does
    assert tree["cls_w"].shape == want["final"]["cls_w"].shape == (8, 32)
    assert got["local_cls_rows"] == 8 // shape[1]
    _assert_trees_match(tree, want["final"])
    # the steps moved the weights and the statistics
    start = _flax_sd(want["start"])
    moved = _flax_sd(tree)
    for k in ("conv1.weight", "bn1.running_mean", "layer4.0.bn3.running_var"):
        assert np.abs(moved[k] - start[k]).max() > 1e-4, k


def test_model_sharded_step_equals_the_one_process_step(port_side,
                                                        jax_side):
    """At (1, 4) every rank sees the whole batch: the classes' split alone
    must give the one-process step."""
    start = jax_side[(1, 4)]["start"]
    state, metrics = _one_process(start, _feature_batches())
    got = port_side[0][(1, 4)]
    for g, w in zip(got["metrics"], metrics):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    want = tsv.flax_state_tree(state)
    assert want["cls_w"].shape == (NUM_CLASSES, 32)
    _assert_trees_match(got["tree"], want, rows=NUM_CLASSES)


def test_state_tree_gathers_the_class_shards(port_side):
    """The port's own tree of each mesh: the global padded classifier, the
    placements of ``state_specs``."""
    for shape in MESHES:
        got = port_side[0][shape]
        own, tree = got["own"], got["tree"]
        np.testing.assert_array_equal(own["cls_w"], tree["cls_w"])
        np.testing.assert_array_equal(own["momentum"]["cls_w"],
                                      tree["momentum"]["cls_w"])
        specs = got["specs"]
        assert specs["cls_w"] == specs["momentum"]["cls_w"] == ("model", None)
        assert set(specs["model"].values()) == {()}
        assert specs["step"] == ()


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rank0_checkpoint_resumes_in_one_process_and_in_jax(
        port_side, jax_side, shape):
    out, out_dir = port_side
    folder = os.path.join(out_dir, f"ckpt_{shape[0]}x{shape[1]}")
    tree = out[shape]["tree"]

    # one process (no mesh: NUM_CLASSES rows, the padded one dropped)
    rec = Checkpointer(folder).recover_if_possible()
    model = ERes2NetV2(**SMALL).double()
    cfg = tsv.SVTrainConfig(**SCHED)
    state = tsv.init_sv_train_state(model, cfg, device="cpu",
                                    cls_w=torch.zeros(NUM_CLASSES, 32,
                                                      dtype=torch.float64))
    tsv.load_state_tree(state, rec["train_state"])
    assert state.step == START + 3
    np.testing.assert_array_equal(state.cls_w.detach().numpy(),
                                  tree["cls_w"][:NUM_CLASSES])
    np.testing.assert_array_equal(state.momentum["cls_w"].numpy(),
                                  tree["momentum"]["cls_w"][:NUM_CLASSES])
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for k, v in _flax_sd(tree).items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)

    # the JAX trainer: the same tree on the same mesh, one more step
    want = jax_side[shape]
    jtree = JaxCheckpointer(folder).recover_if_possible()["train_state"]
    assert (jax.tree_util.tree_structure(jtree)
            == jax.tree_util.tree_structure(want["final"]))
    assert (jax.tree_util.tree_map(np.shape, jtree)
            == jax.tree_util.tree_map(np.shape, want["final"]))
    with jax.enable_x64(True):
        st = jax.device_put(jtree, jsv.state_shardings(jtree, want["mesh"]))
        st, m = want["step"](st, _feature_batches(n=1, seed=9)[0])
    assert int(st["step"]) == START + 4 and np.isfinite(float(m["loss"]))
