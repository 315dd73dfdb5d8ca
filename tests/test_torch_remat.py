"""Remat in the port's SV train step on every kind of backbone.

The JAX step's rule (``speaker3d_tpu/train/sv_train.py``): with ``remat``,
a model with a ``remat`` field recomputes each block (ERes2Net), else one
with a ``memory_efficient`` field each dense layer (CAM++), and any other
backbone its whole forward (ECAPA-TDNN here). For each, at small widths on
the CPU from one start (the port's seeded init, BatchNorm statistics drawn
near 0, in the JAX trainer's layout through ``flax_state_tree``), two
steps:

- with remat against without in the port, in fp32: losses, parameters, SGD
  buffers (the gradients' sums) and BatchNorm statistics within 1e-6,
  every ``num_batches_tracked`` as the plain step's (the recomputation
  updates nothing), and the recomputation really ran (its checkpoint calls
  counted);
- the port's remat step against the JAX remat step on the same features,
  both in float64 (the JAX step under ``jax.enable_x64``): metrics at rtol
  1e-5, parameters, ``cls_w``, statistics and SGD buffers at 1e-5 of the
  largest entry of their kind (measured: 1e-7 on ERes2Net, up to 1.1e-6
  on CAM++'s loss and ECAPA-TDNN's buffers; where the rest rounds in fp32
  is not located: the port's lr comes from its fp32 schedule, the JAX
  step's under x64 in float64). In fp32 these random models' gradients
  are ill-conditioned leaf by leaf (training-mode BatchNorm's backward
  cancels), and a bias before a training-mode BatchNorm has a zero
  gradient but for rounding (``tests/test_torch_ssl.py`` explains).
"""

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.models.campplus import CAMPPlus as JaxCAMPPlus
from speaker3d_tpu.models.ecapa_tdnn import ECAPA_TDNN as JaxECAPA
from speaker3d_tpu.models.eres2net import ERes2Net as JaxERes2Net
from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu.train import sv_train as jsv
from speaker3d_tpu_torch.models import campplus, common
from speaker3d_tpu_torch.models.campplus import CAMPPlus
from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
from speaker3d_tpu_torch.models.eres2net import ERes2Net
from speaker3d_tpu_torch.train import sv_train as tsv
from tests.torch_threads import cap_torch_threads  # noqa: F401

F, T, B = 32, 60, 4
NUM_CLASSES = 6
# steps 20-21 inside the lr warm-up and before the margin ramp: the margin
# is exactly 0 in both packages (the port's fp32 schedule and the JAX step's
# float64 one under x64 would differ by an fp32 ulp, which the scale of 32
# carries into every logit)
SCHED = dict(num_classes=NUM_CLASSES, embedding_size=16, step_per_epoch=10,
             warmup_epoch=5, fix_epoch=12, increase_start_epoch=3,
             margin_fix_epoch=8, final_margin=0.3, max_lr=0.001)
START = 20
TOL = 1e-5                         # float64, against the JAX step
SELF_TOL = 1e-6                    # fp32, remat against plain
# (JAX class, port class, widths, the field remat sets, the module whose
# ``checkpointed`` the recomputation calls)
CASES = {
    "eres2net": (JaxERes2Net, ERes2Net,
                 dict(num_blocks=(1, 1, 1, 1), m_channels=8, feat_dim=F,
                      embedding_size=16), "remat", common),
    "campplus": (JaxCAMPPlus, CAMPPlus,
                 dict(feat_dim=F, embedding_size=16, growth_rate=8,
                      bn_size=2, init_channels=16), "memory_efficient",
                 campplus),
    "ecapa_whole": (JaxECAPA, ECAPA_TDNN,
                    dict(input_size=F, lin_neurons=16,
                         channels=(32, 32, 32, 32, 96), attention_channels=16,
                         se_channels=16), None, tsv),
}


def _batches(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"feats": rng.standard_normal((B, T, F)).astype(np.float32),
             "labels": rng.integers(0, NUM_CLASSES, B).astype(np.int32)}
            for _ in range(n)]


def _start(case) -> dict:
    """The start in the JAX trainer's layout: the port's seeded init with
    BatchNorm statistics near 0, a seeded ``cls_w``, zero buffers."""
    _, tcls, kw, _, _ = CASES[case]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = tcls(**kw)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(0.1 * rng.standard_normal(
                    tuple(buf.shape))))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, tuple(
                    buf.shape))))
    cfg = tsv.SVTrainConfig(**SCHED)
    host = tsv.flax_state_tree(tsv.init_sv_train_state(model, cfg, seed=0,
                                                       device="cpu"))
    host["step"] = np.asarray(START, np.int32)
    return host


def _port_run(case, host, batches, remat, dtype=torch.float32):
    _, tcls, kw, _, holder = CASES[case]
    model = tcls(**kw)
    cfg = tsv.SVTrainConfig(**SCHED, remat=remat)
    state = tsv.init_sv_train_state(model, cfg, device="cpu")
    tsv.load_state_tree(state, host)
    model.to(dtype)
    state.cls_w = state.cls_w.detach().to(dtype).requires_grad_(True)
    state.momentum = {"model": {k: v.to(dtype) for k, v in
                                state.momentum["model"].items()},
                      "cls_w": state.momentum["cls_w"].to(dtype)}
    step = tsv.make_sv_train_step(model, cfg)
    inner, calls = holder.checkpointed, [0]

    def counted(*args):
        calls[0] += 1
        return inner(*args)

    holder.checkpointed = counted
    try:
        metrics = [{k: float(v) for k, v in step(
            state, {"feats": torch.from_numpy(b["feats"]).to(dtype),
                    "labels": torch.from_numpy(b["labels"])}).items()}
            for b in batches]
    finally:
        holder.checkpointed = inner
    return state, metrics, calls[0]


def _jax_run(case, host, batches):
    """The JAX remat step in float64 from ``host``."""
    jcls, _, kw, _, _ = CASES[case]
    jmodel = jcls(**kw)
    with jax.enable_x64(True):
        host = jax.tree_util.tree_map(
            lambda v: v.astype(np.float64) if v.dtype == np.float32 else v,
            host)
        mesh = make_mesh(1, 1, devices=jax.devices()[:1])
        step = jsv.make_sv_train_step(
            jmodel, jsv.SVTrainConfig(**SCHED, remat=True), mesh, host)
        state = jax.device_put(host, jsv.state_shardings(host, mesh))
        metrics = []
        for b in batches:
            state, m = step(state, {"feats": b["feats"].astype(np.float64),
                                    "labels": b["labels"]})
            metrics.append({k: float(v) for k, v in m.items()})
        return jax.tree_util.tree_map(np.asarray,
                                      jax.device_get(state)), metrics


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    case = request.param
    host, batches = _start(case), _batches()
    return (case, _port_run(case, host, batches, False),
            _port_run(case, host, batches, True),
            _port_run(case, host, batches, True, torch.float64)[:2],
            _jax_run(case, host, batches))


def test_remat_equals_plain(runs):
    case, (plain, mp, n_plain), (remat, mr, n_remat), _, _ = runs
    field = CASES[case][3]
    if field is not None:
        assert getattr(remat.model, field) and not getattr(plain.model, field)
    # two steps: per block / dense layer (or once for the whole backbone)
    # a step, never without remat
    assert n_plain == 0 and n_remat >= 2, (n_plain, n_remat)
    if case == "ecapa_whole":
        assert n_remat == 2
    for a, b in zip(mp, mr):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=SELF_TOL,
                                       atol=SELF_TOL, err_msg=k)
    for (k, a), b in zip(plain.model.state_dict().items(),
                         remat.model.state_dict().values()):
        if k.endswith("num_batches_tracked"):
            assert int(a) == int(b) == 2, k
            continue
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=SELF_TOL, err_msg=k)
    for k, a in plain.momentum["model"].items():
        np.testing.assert_allclose(remat.momentum["model"][k].numpy(),
                                   a.numpy(), rtol=0, atol=SELF_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(remat.cls_w.detach().numpy(),
                               plain.cls_w.detach().numpy(), rtol=0,
                               atol=SELF_TOL)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_port_remat_step_matches_the_jax_remat_step(runs):
    _, _, _, (remat, mr), (want, want_metrics) = runs
    for got, wm in zip(mr, want_metrics):
        for k in ("loss", "acc", "lr", "margin"):
            np.testing.assert_allclose(got[k], wm[k], rtol=TOL, err_msg=k)
    got = dict(_flatten(tsv.flax_state_tree(remat)))
    assert sorted(got) == sorted(k for k, _ in _flatten(want))
    largest = {}
    for key, v in _flatten(want):
        kind = key[:2] if key[0] == "momentum" else key[:1]
        largest[kind] = max(largest.get(kind, 0.0), float(np.abs(v).max()))
    for key, v in _flatten(want):
        kind = key[:2] if key[0] == "momentum" else key[:1]
        np.testing.assert_allclose(got[key].reshape(v.shape), v, rtol=0,
                                   atol=TOL * max(largest[kind], 1.0),
                                   err_msg=str(key))
