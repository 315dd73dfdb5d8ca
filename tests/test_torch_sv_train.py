"""The port's SV train step against the JAX ``make_sv_train_step``.

The JAX step runs on a 1x1 mesh (one device holds the batch and every
class) with ``feature_fn=KaldiFbank(mean_norm=True)``, the port's on the
CPU with its own ``KaldiFbank``; both start from the same converted weights
and ``cls_w``, with the step counter inside the lr warm-up and inside the
margin ramp. Per step the loss, accuracy, lr and margin agree at rtol
1e-4; after three steps the parameters, ``cls_w`` and BatchNorm running
statistics agree at atol 1e-4, and the SGD buffers at 1e-4 of their scale
(each buffer's on the same features, the largest buffer's with each
package's own fbank). The int16 wire gives what float32
gives, and per-block remat what the plain step gives, running statistics
included. The bf16 step (``compute_dtype: bfloat16``) is held against the
JAX bf16 step on ERes2NetV2 with and without remat and on CAM++ at the
tolerances stated above ``BF16_TOL``, and the BatchNorm on a bf16 input
against Flax's under ``bn_compute_dtype``.
"""

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.models.campplus import CAMPPlus as JaxCAMPPlus
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu.ops.fbank import FbankConfig as JaxFbankConfig
from speaker3d_tpu.ops.fbank import KaldiFbank as JaxKaldiFbank
from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu.train import sv_train as jsv
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models.campplus import CAMPPlus
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.parallel.mesh import make_mesh as make_port_mesh
from speaker3d_tpu_torch.train import sv_train as tsv
from speaker3d_tpu_torch.utils.threads import cpu_threads
from tests.test_torch_eres2netv2 import jax_variables
from tests.torch_threads import cap_torch_threads, worker_threads  # noqa: F401

SMALL = dict(num_blocks=(1, 1, 1, 1), m_channels=8, feat_dim=80,
             embedding_size=32)
NUM_CLASSES = 6
# 10 steps per epoch: warm-up runs to step 50, the margin ramps over steps
# 10-80; every compared step (20-22) lies inside both. This small random
# model's loss is sharp: a weight change of 1e-3 moves bn1.bias's gradient by
# O(1), so the two packages' fbank rounding (up to 2e-5 in log-mel on these
# broadband batches, 1e-4 in the low-power bins of near-tonal ones) grows
# step by step. At the config's peak lr 0.2 (0.08 at step 20) the weights
# move by up to 1.7 per step and differ by 6e-3 after three steps; at a peak
# of 0.001 (4.6e-4 at step 20) they differ by ~1e-6.
SCHED = dict(num_classes=NUM_CLASSES, embedding_size=32, step_per_epoch=10,
             warmup_epoch=5, fix_epoch=12, increase_start_epoch=1,
             margin_fix_epoch=8, final_margin=0.3, max_lr=0.001)
START = 20
TOL = 1e-4
PORT_THREADS = 2  # the fp32 three-step comparison's (see below)


def _batches(n=3, b=4, samples=8000, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = np.arange(samples) / 16000
        f0 = rng.uniform(100, 400, (b, 1))
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.3 * rng.standard_normal((b, samples)))
        pcm = np.round(np.clip(wav, -1, 1 - 1 / 32768) * 32768) / 32768
        out.append({"wavs": pcm.astype(np.float32),
                    "labels": rng.integers(0, NUM_CLASSES, b).astype(np.int32)})
    return out


@pytest.fixture(scope="module")
def start():
    jmodel = JaxERes2NetV2(**SMALL)
    variables = jax_variables(jmodel)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    cfg = jsv.SVTrainConfig(**SCHED)
    state = jsv.init_sv_train_state(
        jax.random.PRNGKey(0), jmodel, np.zeros((1, 48, 80), np.float32),
        cfg, mesh, backbone_variables=variables)
    host = jax.tree_util.tree_map(np.asarray, jax.device_get(state))
    host["step"] = np.asarray(START, np.int32)
    return jmodel, mesh, cfg, host


def _jax_run(start, batches, fbank=True):
    jmodel, mesh, cfg, host = start
    step = jsv.make_sv_train_step(
        jmodel, cfg, mesh, host,
        feature_fn=(JaxKaldiFbank(JaxFbankConfig(), mean_norm=True)
                    if fbank else None))
    state = jax.device_put(host, jsv.state_shardings(host, mesh))
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree_util.tree_map(np.asarray, jax.device_get(state)), metrics


def _port_state(host, remat=False, fbank=True):
    model = ERes2NetV2(**SMALL)
    model.load_state_dict(state_dict_from_flax(
        {"params": host["params"], "batch_stats": host["batch_stats"]}),
        strict=True)
    cfg = tsv.SVTrainConfig(**SCHED, remat=remat)
    state = tsv.init_sv_train_state(model, cfg, device="cpu",
                                    cls_w=host["cls_w"])
    state.step = int(host["step"])
    feature_fn = (KaldiFbank(FbankConfig(), mean_norm=True, device="cpu")
                  if fbank else None)
    return state, tsv.make_sv_train_step(model, cfg, feature_fn=feature_fn)


def _port_run(host, batches, remat=False, wire=None):
    state, step = _port_state(host, remat, fbank="wavs" in batches[0])
    metrics = []
    for batch in batches:
        if "feats" in batch:
            m = step(state, {k: torch.tensor(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            continue
        wavs = batch["wavs"]
        if wire == "int16":
            wavs = np.clip(np.rint(wavs * 32768.0), -32768, 32767).astype(
                np.int16)
        m = step(state, {"wavs": torch.from_numpy(wavs),
                         "labels": torch.from_numpy(batch["labels"])})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _assert_states_match(state, want_state, mom_tol):
    sd = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    want_sd = state_dict_from_flax({"params": want_state["params"],
                                    "batch_stats": want_state["batch_stats"]})
    assert sorted(sd) == sorted(want_sd)
    for k, v in want_sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k], v.numpy(), rtol=0, atol=TOL,
                                       err_msg=k)
    np.testing.assert_allclose(state.cls_w.detach().numpy(),
                               want_state["cls_w"], rtol=0, atol=TOL)
    want_mom = state_dict_from_flax({"params": want_state["momentum"]["params"]})
    want_mom = {k: v.numpy() for k, v in want_mom.items()}
    want_mom["cls_w"] = want_state["momentum"]["cls_w"]
    got_mom = {k: v.numpy() for k, v in state.momentum["model"].items()}
    got_mom["cls_w"] = state.momentum["cls_w"].numpy()
    assert sorted(got_mom) == sorted(want_mom)
    for k, v in want_mom.items():
        np.testing.assert_allclose(got_mom[k], v, rtol=0, atol=mom_tol(v),
                                   err_msg=k)
    return sd


def _jax_features(batches):
    fbank = JaxKaldiFbank(JaxFbankConfig(), mean_norm=True)
    return [{"feats": np.asarray(fbank(b["wavs"])), "labels": b["labels"]}
            for b in batches]


@pytest.fixture(scope="module")
def jax_three_steps(start):
    return _jax_run(start, _batches())


def _check_three_steps(start, jax_three_steps):
    batches = _batches()
    want_state, want = jax_three_steps
    # torch's CPU conv2d weight gradient sums in an order that depends on
    # the intra-op thread count: one thread moves conv1.weight's gradient
    # by 1.4e-6 of its size against two or more, and this sharp model turns
    # that into 0.036 of conv1.weight's SGD buffer after three steps (2-8
    # threads: 7e-4 from the JAX buffers). The port's steps run at a stated
    # count, so the xdist worker's share of the cores does not decide it.
    with cpu_threads(PORT_THREADS):
        state, got = _port_run(start[3], batches)
    assert state.step == START + 3 == int(want_state["step"])
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "acc", "lr", "margin"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    assert 1e-4 < got[0]["lr"] < 0.001 and 0 < got[0]["margin"] < 0.3
    top = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(
        want_state["momentum"]))
    assert top > 1.0
    sd = _assert_states_match(state, want_state, lambda v: TOL * top)
    # the steps moved the weights and the statistics
    start_sd = state_dict_from_flax(
        {"params": start[3]["params"], "batch_stats": start[3]["batch_stats"]})
    for k in ("conv1.weight", "bn1.running_mean", "layer4.0.bn3.running_var"):
        assert np.abs(sd[k] - start_sd[k].numpy()).max() > 1e-4, k


def test_three_steps_match_the_jax_step(start, jax_three_steps):
    """Each package with its own fbank. An SGD buffer is a sum of
    gradients (up to ~30 here), and the fbanks' rounding moves this sharp
    model's gradients by up to ~1e-4 of their size, so the buffers are held
    at TOL of the largest buffer;
    ``test_three_steps_on_the_same_features_match_the_jax_step`` holds them
    per buffer on the same features."""
    _check_three_steps(start, jax_three_steps)


def test_three_steps_match_the_jax_step_from_one_thread(start,
                                                        jax_three_steps):
    """The same comparison called from a single-threaded process (a worker
    whose share of the cores is one): the port's steps still run at
    PORT_THREADS."""
    with cpu_threads(1):
        _check_three_steps(start, jax_three_steps)


def test_three_steps_on_the_same_features_match_the_jax_step(start):
    """The JAX fbank's features into both steps: the rest of the step (the
    backbone in train mode, classifier, loss, SGD) holds every SGD buffer
    at TOL of its own scale."""
    batches = _jax_features(_batches())
    want_state, want = _jax_run(start, batches, fbank=False)
    state, got = _port_run(start[3], batches)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    _assert_states_match(state, want_state,
                         lambda v: TOL * max(1.0, float(np.abs(v).max())))


def test_int16_wire_equals_float32(start):
    batches = _batches(n=2, seed=1)
    s32, m32 = _port_run(start[3], batches)
    s16, m16 = _port_run(start[3], batches, wire="int16")
    assert m32 == m16
    for (k, a), b in zip(s32.model.state_dict().items(),
                         s16.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_remat_equals_plain(start):
    batches = _batches(n=2, seed=2)
    plain, mp = _port_run(start[3], batches)
    remat, mr = _port_run(start[3], batches, remat=True)
    assert remat.model.remat and not plain.model.remat
    for a, b in zip(mp, mr):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6)
    for (k, a), b in zip(plain.model.state_dict().items(),
                         remat.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    # the backward's recomputation did not count as a second update
    assert int(remat.model.bn1.num_batches_tracked) == 2
    assert int(remat.model.layer1[0].bn1.num_batches_tracked) == 2


def test_unported_options_are_refused():
    model = ERes2NetV2(**SMALL)
    cfg = tsv.SVTrainConfig(num_classes=4)
    # bfloat16 runs (test_bf16_steps_match_the_jax_bf16_step); an unknown
    # dtype is refused
    with pytest.raises(ValueError, match="float16"):
        tsv.make_sv_train_step(model, cfg._replace(compute_dtype="float16"))
    # the classes split over two shards need two ranks: one process is a
    # world of one
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        tsv.make_sv_train_step(model, cfg, mesh=make_port_mesh(
            1, 2, device="cpu"))
    # remat runs on every backbone (tests/test_torch_remat.py): CAM++ takes
    # it as its memory_efficient field
    from speaker3d_tpu_torch.models.campplus import CAMPPlus

    cam = CAMPPlus(feat_dim=80, embedding_size=32)
    tsv.make_sv_train_step(cam, cfg._replace(remat=True))
    assert cam.memory_efficient



# The bf16 step. Both packages get the JAX fbank's features (the fbank runs
# in fp32 before the cast, so this isolates the backbone), and the JAX step
# is compiled with ``xla_allow_excess_precision`` off: XLA on the CPU
# otherwise keeps some bf16 results in fp32 where an fp32 op consumes them,
# and its step lies as far from a bf16 step that rounds every op's output
# (as cuDNN and oneDNN do) as an fp32 step does (measured: first-step loss
# 11.1025 with excess precision, 11.0294 without, the port's 11.0430, the
# fp32 step's 11.1074).
#
# On these random small models a bf16 rounding flip in one activation
# spreads through every later layer, ~3-10x per residual block, so two bf16
# implementations that round a few elements differently decorrelate deep in
# the trunk. Three chained steps therefore hold the port's bf16 step to the
# JAX bf16 step only at the level of that noise (measured on ERes2NetV2,
# without and with remat: loss within 4.4% and 3.4%, acc equal, the median
# parameter update at cosine 0.971 and 0.964, the running statistics 0.21%
# and 0.20% of their movement (median over statistics), cls_w 7.5% and
# 7.1% of its movement; the fp32 step: 1.1-2.1%, equal, 0.94-0.93, 0.30%,
# 9.3%). What tells bf16 from fp32 is the first step, from one state,
# before the flips have spread: its loss (1.2e-3 relative, the fp32 step
# 7.1e-3) and the first BatchNorm's batch statistics (4.9e-6 and 8.1e-6 of
# their movement, the fp32 step 2.0e-4 and 1.7e-3; CAM++ 0 and 2.2e-6
# against 1.7e-4 and 1.2e-3).
BF16_TOL = dict(loss=0.1, update_cos=0.9, stats=0.01, cls_w=0.2)
BF16_RATIO = 0.25
CAM_SMALL = dict(feat_dim=80, embedding_size=32, growth_rate=8, bn_size=2,
                 init_channels=16)
BF16_CASES = {"eres2netv2": (JaxERes2NetV2, ERes2NetV2, SMALL, False),
              "eres2netv2_remat": (JaxERes2NetV2, ERes2NetV2, SMALL, True),
              "campplus": (JaxCAMPPlus, CAMPPlus, CAM_SMALL, False)}
NO_EXCESS = {"xla_allow_excess_precision": False}


def _jax_bf16(case, host, batches):
    """The JAX bf16 step's per-step losses and accuracies, the state after
    the first step and after the last; for CAM++, whose bf16 step takes
    ~75 s to lower and compile on an 8-core CPU, the train-mode bf16
    forward of the first step (the step's ``backbone_fwd``: its batch
    statistics)."""
    from speaker3d_tpu.models.common import bn_compute_dtype

    jcls, _, kw, remat = BF16_CASES[case]
    jmodel = jcls(**kw)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    if case == "campplus":
        def fwd(params, feats):
            params = jax.tree_util.tree_map(
                lambda x: x.astype(jax.numpy.bfloat16), params)
            with bn_compute_dtype(jax.numpy.bfloat16):
                _, mutated = jmodel.apply(
                    {"params": params, "batch_stats": host["batch_stats"]},
                    feats.astype(jax.numpy.bfloat16), train=True,
                    mutable=["batch_stats"])
            return jax.tree_util.tree_map(
                lambda x: x.astype(jax.numpy.float32), mutated)
        feats = batches[0]["feats"]
        mutated = jax.jit(fwd).lower(host["params"], feats).compile(
            NO_EXCESS)(host["params"], feats)
        first = {"params": host["params"],
                 "batch_stats": jax.device_get(mutated["batch_stats"])}
        return None, first, None
    cfg = jsv.SVTrainConfig(**SCHED, compute_dtype="bfloat16", remat=remat)
    step = jsv.make_sv_train_step(jmodel, cfg, mesh, host)
    state = jax.device_put(host, jsv.state_shardings(host, mesh))
    step = step.lower(state, batches[0]).compile(NO_EXCESS)
    metrics, first = [], None
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if first is None:
            first = jax.tree_util.tree_map(np.asarray, jax.device_get(state))
    return metrics, first, jax.tree_util.tree_map(np.asarray,
                                                  jax.device_get(state))


def _port_steps(case, host, batches, dtype, remat):
    """The port's steps from ``host``; the metrics, the state dict after
    the first step, the state after the last."""
    _, tcls, kw, _ = BF16_CASES[case]
    model = tcls(**kw)
    model.load_state_dict(state_dict_from_flax(
        {"params": host["params"], "batch_stats": host["batch_stats"]},
        like=model.state_dict()), strict=True)
    cfg = tsv.SVTrainConfig(**SCHED, remat=remat, compute_dtype=dtype)
    state = tsv.init_sv_train_state(model, cfg, device="cpu",
                                    cls_w=host["cls_w"])
    state.step = START
    step = tsv.make_sv_train_step(model, cfg)
    metrics, first = [], None
    for batch in batches:
        m = step(state, {k: torch.tensor(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if first is None:
            first = {k: v.clone() for k, v in model.state_dict().items()}
    return metrics, first, state


@pytest.fixture(scope="module")
def bf16_start():
    """Per case: the JAX init (randomised BN statistics), step START."""
    out = {}
    for case, (jcls, _, kw, _) in BF16_CASES.items():
        if case.endswith("_remat"):
            out[case] = out[case[:-len("_remat")]]
            continue
        jmodel = jcls(**kw)
        mesh = make_mesh(1, 1, devices=jax.devices()[:1])
        state = jsv.init_sv_train_state(
            jax.random.PRNGKey(0), jmodel, np.zeros((1, 48, 80), np.float32),
            jsv.SVTrainConfig(**SCHED), mesh,
            backbone_variables=jax_variables(jmodel))
        host = jax.tree_util.tree_map(np.asarray, jax.device_get(state))
        host["step"] = np.asarray(START, np.int32)
        out[case] = host
    return out


def _sd(tree, like):
    return state_dict_from_flax(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]},
        like=like)


def _stats_gap(sd, want, start, keys):
    """Per BatchNorm statistic: the mean difference over the mean movement
    of the JAX step's statistic."""
    return [float((sd[k] - want[k]).abs().mean()
                  / (want[k] - start[k]).abs().mean()) for k in keys]


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_steps_match_the_jax_bf16_step(bf16_start, case):
    """Three chained bf16 steps within BF16_TOL of the JAX bf16 step (the
    noise level: see BF16_TOL); the first step's loss and first BatchNorm's
    batch statistics within BF16_RATIO of the fp32 step's distance from the
    JAX bf16 step. CAM++: its first step's batch statistics against the JAX
    bf16 train-mode forward, and its three bf16 steps finite, their updates
    at a median cosine above 0.2 with the fp32 steps' (measured 0.42: bf16
    noise dominates this random CAM++'s gradients, whose deep trunk differs
    from the fp32 trunk by ~23% in either package)."""
    host = bf16_start[case]
    remat = BF16_CASES[case][3]
    batches = _jax_features(_batches())
    want, jfirst, jlast = _jax_bf16(case, host, batches)
    # this worker's share of the cores: at torch's default count the small
    # CAM++ steps slow down ~50x on a host shared with other workers (this
    # file's fp32 comparisons stay at the default: ROADMAP.md Queue 3)
    with cpu_threads(worker_threads()):
        got, first16, state16 = _port_steps(case, host, batches, "bfloat16",
                                            remat)
        got32, first32, state32 = _port_steps(case, host, batches,
                                              "float32", remat)
    like = state16.model.state_dict()
    start = _sd(host, like)
    stats = [k for k in like if k.endswith(("running_mean", "running_var"))]
    for sd in (first16, like):  # fp32 buffers, fp32 masters
        assert all(v.dtype in (torch.float32, torch.int64)
                   for v in sd.values())
    # the first step: bf16 against fp32, each against the JAX bf16 step
    want1 = _sd(jfirst, like)
    gap16 = _stats_gap(first16, want1, start, stats[:2])
    gap32 = _stats_gap(first32, want1, start, stats[:2])
    assert max(gap16) <= BF16_RATIO * min(gap32), (gap16, gap32)
    assert float(np.median(_stats_gap(first16, want1, start, stats))) \
        <= BF16_TOL["stats"]
    if want is None:  # CAM++: the port's steps against its fp32 steps
        for m in got:
            assert np.isfinite(m["loss"]) and 0 <= m["acc"] <= 1
        last32 = state32.model.state_dict()
        cos = []
        for name, _ in state16.model.named_parameters():
            u = (like[name] - start[name]).flatten().double()
            w = (last32[name] - start[name]).flatten().double()
            cos.append(float(u @ w / (u.norm() * w.norm())))
        assert np.median(cos) > 0.2, np.median(cos)
        return
    l16 = abs(got[0]["loss"] - want[0]["loss"])
    l32 = abs(got32[0]["loss"] - want[0]["loss"])
    assert l16 <= BF16_RATIO * l32, (l16, l32)
    # three chained steps
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= BF16_TOL["loss"] * abs(w["loss"])
        assert g["acc"] == w["acc"] and g["lr"] == pytest.approx(w["lr"])
    end = _sd(jlast, like)
    cos = []
    for name, _ in state16.model.named_parameters():
        u = (like[name] - start[name]).flatten().double()
        w = (end[name] - start[name]).flatten().double()
        cos.append(float(u @ w / (u.norm() * w.norm())))
    assert np.median(cos) >= BF16_TOL["update_cos"], np.median(cos)
    assert float(np.median(_stats_gap(like, end, start, stats))) \
        <= BF16_TOL["stats"]
    cls_w = state16.cls_w.detach().numpy()
    assert (np.abs(cls_w - jlast["cls_w"]).mean()
            <= BF16_TOL["cls_w"] * np.abs(jlast["cls_w"] - host["cls_w"]).mean())
    if remat:  # the recomputation reads the same bf16 casts: bit-equal
        with cpu_threads(worker_threads()):
            plain, _, plain_state = _port_steps(case, host, batches,
                                                "bfloat16", False)
        assert plain == got
        for k, v in plain_state.model.state_dict().items():
            assert torch.equal(v, like[k]), k


@pytest.mark.parametrize("kind,shape,affine", [
    ("2d", (4, 6, 5, 7), True), ("1d", (5, 6, 9), False)])
def test_bn_bf16_input_like_flax_bn_compute_dtype(kind, shape, affine):
    """The port's BatchNorm on a bf16 input with bf16 weights (a bf16 step's
    casts) against ``flax.linen.BatchNorm`` under ``bn_compute_dtype(
    bfloat16)`` with the same casts: a bf16 output (both normalise in fp32
    with the bf16-rounded scale and bias and round once: bit-equal on the
    CPU; held within one bf16 step of its scale, with under 5% of the
    elements on the other side of a rounding), fp32 running statistics at
    1e-6 (both reduce the bf16 input in fp32)."""
    import jax.numpy as jnp

    from speaker3d_tpu.models.common import batch_norm, bn_compute_dtype
    from speaker3d_tpu_torch.models.common import batch_norm1d, batch_norm2d

    rng = np.random.default_rng(7)
    C = shape[1]
    to_flax = (0, *range(2, len(shape)), 1)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    x16 = torch.from_numpy(x).bfloat16()
    params = ({"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
               "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
              if affine else {})
    stats = {"mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    with bn_compute_dtype(jnp.bfloat16):
        flax_bn = batch_norm(True, use_bias=affine, use_scale=affine)
        out, mutated = flax_bn.apply(
            {"params": jax.tree_util.tree_map(
                lambda v: jnp.asarray(v, jnp.bfloat16), params),
             "batch_stats": stats},
            jnp.asarray(x16.float().numpy().transpose(to_flax), jnp.bfloat16),
            mutable=["batch_stats"])
    layer = batch_norm2d(C) if kind == "2d" else batch_norm1d(C, affine=affine)
    layer.load_state_dict(state_dict_from_flax(
        {"params": params, "batch_stats": stats}), strict=True)
    layer.train()
    with tsv.bf16_parameters(layer):
        got = layer(x16)
    assert got.dtype == torch.bfloat16 and out.dtype == jnp.bfloat16
    want = np.asarray(out.astype(jnp.float32))
    got = got.float().detach().numpy().transpose(to_flax)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
    assert np.mean(got != want) < 0.05
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        buf = getattr(layer, name)
        assert buf.dtype == torch.float32
        assert mutated["batch_stats"][key].dtype == jnp.float32
        np.testing.assert_allclose(buf.numpy(), mutated["batch_stats"][key],
                                   rtol=0, atol=1e-6)
    # the parameters are the fp32 masters again after the block
    assert all(p.dtype == torch.float32 for p in layer.parameters())
