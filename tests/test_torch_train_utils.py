"""The trainer's host utilities against the JAX package's: config and
builder, checkpoints and the epoch log, meters, the schedules and the
margin losses.
"""

import glob
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import example, given, settings
from hypothesis import strategies as st

from speaker3d_tpu.train import losses as jl
from speaker3d_tpu.train import schedulers as js
from speaker3d_tpu.utils import checkpoint as jck
from speaker3d_tpu.utils import config as jcfg
from speaker3d_tpu.utils import misc as jmisc
from speaker3d_tpu_torch.train import losses as tl
from speaker3d_tpu_torch.train import schedulers as ts
from speaker3d_tpu_torch.utils import builder as tb
from speaker3d_tpu_torch.utils import checkpoint as tck
from speaker3d_tpu_torch.utils import config as tcfg
from speaker3d_tpu_torch.utils import misc as tmisc
from speaker3d_tpu_torch.utils import preemption as tpre
from speaker3d_tpu_torch.utils.profiling import StepTracer
from tests.torch_threads import cap_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["--exp_dir=exp/x", "--num_epoch", "1", "--remat=true",
             "--model", "{obj: a.B, args: {k: [1, 2]}}", "--max_lr=0.1"]


def test_build_config_equals_jax(tmp_path):
    path = os.path.join(ROOT, "configs", "eres2netv2.yaml")
    ov = [o.replace("exp/x", str(tmp_path / "exp")) for o in OVERRIDES]
    got = tcfg.build_config(path, ov, copy_to_exp_dir=True)
    want = jcfg.build_config(path, ov)
    assert got.as_dict() == want.as_dict()
    assert got["remat"] is True and got.max_lr == 0.1 and "num_epoch" in got
    with open(tmp_path / "exp" / "config.yaml") as f:
        assert yaml.safe_load(f) == want.as_dict()
    with pytest.raises(ValueError, match="missing value"):
        tcfg.parse_overrides(["--lr"])
    with pytest.raises(ValueError, match="unexpected"):
        tcfg.parse_overrides(["lr=1"])


def test_every_config_model_maps_to_the_port():
    seen = 0
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))):
        with open(path) as f:
            cfg = yaml.safe_load(f)
        specs = [v for v in cfg.values() if isinstance(v, dict) and "obj" in v]
        for spec in specs:
            obj = spec["obj"]
            cls = tb.dynamic_import(obj)
            assert cls.__module__ == tb.port_path(obj).rsplit(".", 1)[0]
            assert cls.__module__.startswith("speaker3d_tpu_torch.models.")
            # the port's constructor takes the config's (JAX) argument names
            assert isinstance(cls(**spec.get("args", {})), torch.nn.Module)
            seen += 1
    assert seen >= 9
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tb.dynamic_import("speaker3d_tpu.models.eres2netv2.NoSuchNet")


@pytest.mark.parametrize("obj", ["speaker3d_tpu.models.fsmn_vad.FSMNVad",
                                 "speaker3d_tpu.models.segmentation.FSMNSegmenter"])
def test_fsmn_models_map_to_the_port(obj):
    """The JAX builder returns these classes; the port's returns its own."""
    cls = tb.dynamic_import(obj)
    assert cls.__module__ == tb.port_path(obj).rsplit(".", 1)[0]
    assert cls.__module__ in ("speaker3d_tpu_torch.models.fsmn_vad",
                              "speaker3d_tpu_torch.models.segmentation")
    assert cls.__name__ == obj.rsplit(".", 1)[1]


@pytest.mark.parametrize("name", ["RDINOHead", "SDPNHead", "RDINOCombiner",
                                  "SDPNCombiner", "WeightNormedLinear"])
def test_ssl_heads_map_to_the_port(name):
    """models.ssl_heads is no longer refused: the builder returns the
    port's classes."""
    assert "speaker3d_tpu_torch.models.ssl_heads" not in tb.NOT_PORTED
    cls = tb.dynamic_import(f"speaker3d_tpu.models.ssl_heads.{name}")
    assert cls.__module__ == "speaker3d_tpu_torch.models.ssl_heads"
    assert cls.__name__ == name
    spec = {"obj": "speaker3d_tpu.models.ssl_heads.SDPNHead",
            "args": {"in_dim": 16, "hidden_dim": 8, "bottleneck_dim": 4}}
    head = tb.build("head", tcfg.Config({"head": spec}))
    assert head(torch.ones((2, 16))).shape == (2, 4)


@pytest.mark.parametrize("obj", [
    "speaker3d_tpu.models.face_detector.TinyFaceDetector",
    "speaker3d_tpu.models.talknet.TalkNetModel"])
def test_video_models_map_to_the_port(obj):
    """models.face_detector and models.talknet are no longer refused: the
    builder returns the port's classes, and nothing is refused."""
    assert tb.NOT_PORTED == {}
    cls = tb.dynamic_import(obj)
    assert cls.__module__ == tb.port_path(obj).rsplit(".", 1)[0]
    assert cls.__name__ == obj.rsplit(".", 1)[1]


def test_builder_builds_nested_specs_and_references():
    config = tcfg.Config({
        "exp_dir": "exp/a",
        "ckpt": "<exp_dir>/models",
        "model": {"obj": "speaker3d_tpu.models.xvector.Xvector",
                  "args": {"feat_dim": 80, "embed_dim": 16}},
        "both": ["<model>", {"dir": "<ckpt>"}],
        "loop": "<loop>",
    })
    b = tb.Builder(config)
    both = b.build("both")
    assert both[0] is b.build("model")
    assert type(both[0]).__module__ == "speaker3d_tpu_torch.models.xvector"
    assert both[1] == {"dir": "exp/a/models"}
    with pytest.raises(ValueError, match="circular"):
        tb.build("loop", config)


def test_checkpoint_layout_equals_jax(tmp_path):
    tree = {"a": {"b.c": np.arange(3, dtype=np.float32)},
            "step": np.asarray(4, np.int32)}
    layouts = {}
    for name, ck in (("jax", jck), ("torch", tck)):
        counter = ck.EpochCounter(7)
        next(counter)
        c = ck.Checkpointer(str(tmp_path / name), {"epoch_counter": counter})
        d = c.save_checkpoint(1, {"train_state": tree})
        c.save_checkpoint(2, {"train_state": tree})
        with open(os.path.join(d, "CKPT.yaml")) as f:
            meta = yaml.safe_load(f)
        layouts[name] = (sorted(os.listdir(tmp_path / name)), sorted(os.listdir(d)),
                         sorted(meta))
        with np.load(os.path.join(d, "train_state.ckpt")) as z:
            assert sorted(z.files) == ["a/b.c", "step"]
    assert layouts["torch"] == layouts["jax"]
    assert layouts["torch"][0] == ["CKPT-EPOCH-1-00", "CKPT-EPOCH-2-00"]
    # each package reads what the other wrote
    for src, ck in (("jax", tck), ("torch", jck)):
        counter = ck.EpochCounter(7)
        got = ck.Checkpointer(str(tmp_path / src),
                              {"epoch_counter": counter}).recover_if_possible(1)
        assert counter.current == 1 and got["__meta__"]["epoch"] == 1
        np.testing.assert_array_equal(got["train_state"]["a"]["b.c"],
                                      tree["a"]["b.c"])
    assert tck.Checkpointer(str(tmp_path / "none")).recover_if_possible() is None


def test_epoch_logger_lines_byte_equal(tmp_path):
    stats = [({"epoch": 1, "time_s": 12.3, "data_wait_s": 0.4},
              {"avg_loss": 9.87654321, "avg_acc": None}),
             ({"epoch": 2, "time_s": 1.0, "data_wait_s": 0.0}, None)]
    for name, ck in (("jax", jck), ("torch", tck)):
        log = ck.EpochLogger(str(tmp_path / name / "train_epoch.log"))
        for meta, s in stats:
            log.log_stats(meta, s)
    assert ((tmp_path / "torch" / "train_epoch.log").read_bytes()
            == (tmp_path / "jax" / "train_epoch.log").read_bytes())


def test_meters_equal_jax(capsys):
    outs = []
    for m in (jmisc, tmisc):
        meters = m.AverageMeters()
        for i, v in enumerate([3.0, 1.5, 2.25]):
            meters.update("loss", v, n=i + 1, fmt=":.3f")
            meters.update("acc", v / 4)
        line = m.ProgressMeter(30, meters, prefix="Epoch 1 ").display(7)
        outs.append((str(meters), line, meters.avg("loss")))
    assert outs[0] == outs[1]
    assert (tmisc.utt2spk_to_spk2utt({"u1": "a", "u2": "b", "u3": "a"})
            == jmisc.utt2spk_to_spk2utt({"u1": "a", "u2": "b", "u3": "a"}))
    vals = [torch.tensor(1.5), torch.tensor(2.0), torch.tensor(4.0)]
    assert tmisc.fetch_mean(vals) == pytest.approx(
        jmisc.fetch_mean([jnp.asarray(1.5), 2.0, 4.0]))
    with pytest.raises(ValueError):
        tmisc.fetch_mean([])


SCHED_KW = dict(min_lr=1e-4, max_lr=0.2, warmup_epoch=5, fix_epoch=70)
MARGIN_KW = dict(increase_start_epoch=20, fix_epoch=50, initial_margin=0.0,
                 final_margin=0.3)


@settings(max_examples=60, deadline=None)
@given(step=st.integers(0, 9000), spe=st.integers(1, 130),
       itype=st.sampled_from(["exp", "linear"]))
@example(step=4942, spe=75, itype="exp")  # 1 + cos cancels: cos = -0.98
def test_schedules_equal_jax(step, spe, itype):
    got = float(ts.warmup_cosine_lr(step, step_per_epoch=spe, **SCHED_KW))
    want = float(js.warmup_cosine_lr(step, step_per_epoch=spe, **SCHED_KW))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-9)
    got = float(ts.margin_at_step(step, step_per_epoch=spe,
                                  increase_type=itype, **MARGIN_KW))
    want = float(js.margin_at_step(step, step_per_epoch=spe,
                                   increase_type=itype, **MARGIN_KW))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    got = float(ts.step_lr(step, lr=0.1, step_per_epoch=spe,
                           step_epoch_size=7))
    want = float(js.step_lr(step, lr=0.1, step_per_epoch=spe,
                            step_epoch_size=7))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


SWEEP_SPE = 75
SWEEPS = {
    # name: (port fn, JAX fn, kwargs, first step, abs bound)
    "warmup_cosine_lr": (ts.warmup_cosine_lr, js.warmup_cosine_lr, SCHED_KW,
                         SCHED_KW["warmup_epoch"] * SWEEP_SPE, 1e-9),
    "margin_at_step_exp": (ts.margin_at_step, js.margin_at_step,
                           dict(MARGIN_KW, increase_type="exp"),
                           MARGIN_KW["increase_start_epoch"] * SWEEP_SPE,
                           1e-7),
    "margin_at_step_linear": (ts.margin_at_step, js.margin_at_step,
                              dict(MARGIN_KW, increase_type="linear"),
                              MARGIN_KW["increase_start_epoch"] * SWEEP_SPE,
                              1e-7),
    "step_lr": (ts.step_lr, js.step_lr, dict(lr=0.1, step_epoch_size=7), 0,
                1e-12),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_schedule_sweeps_equal_jax(name):
    """Every step of the ramp (warm-up to ``fix_epoch``, one epoch past it)
    at 75 steps an epoch, elementwise at the hypothesis test's bounds."""
    tfn, jfn, kw, first, abs_tol = SWEEPS[name]
    steps = np.arange(first, 71 * SWEEP_SPE + 1)
    got = tfn(torch.from_numpy(steps), step_per_epoch=SWEEP_SPE, **kw)
    want = np.asarray(jfn(jnp.asarray(steps), step_per_epoch=SWEEP_SPE, **kw))
    # pytest.approx's bound: the larger of rel and abs
    bad = np.abs(got.numpy() - want) > np.maximum(1e-6 * np.abs(want),
                                                  abs_tol)
    assert not bad.any(), (steps[bad][:5], got.numpy()[bad][:5], want[bad][:5])


def _cosines(seed, b=16, c=10):
    """Cosines over the whole range, some of each row's below th =
    cos(pi - m) (the mmm branch) and near +-1."""
    rng = np.random.default_rng(seed)
    cos = rng.uniform(-1, 1, (b, c)).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[:4] = 0
    cos[:4, 0] = rng.uniform(-1.0, -0.985, 4)  # below th for m >= 0.2
    cos[4, labels[4]] = 1.0
    return cos, labels


@pytest.mark.parametrize("margin", [0.0, 0.2, 0.3, 0.5])
@pytest.mark.parametrize("easy", [False, True])
def test_margin_losses_equal_jax(margin, easy):
    cos, labels = _cosines(int(margin * 10) + easy)
    th = np.cos(np.pi - margin)
    assert (cos[np.arange(len(labels)), labels] <= th).any() or margin == 0.0
    tc, tlab = torch.from_numpy(cos), torch.from_numpy(labels)
    pairs = [
        (tl.arc_margin_logits(tc, tlab, margin, 32.0, easy),
         jl.arc_margin_logits(cos, labels, margin, 32.0, easy)),
        (tl.arc_margin_loss(tc, tlab, margin, 32.0, easy),
         jl.arc_margin_loss(cos, labels, margin, 32.0, easy)),
        (tl.add_margin_loss(tc, tlab, margin, 32.0),
         jl.add_margin_loss(cos, labels, margin, 32.0)),
        (tl.entropy_loss(tc * 5, tlab), jl.entropy_loss(cos * 5, labels)),
        # one shard: the per-example CE of the JAX (unsharded) AAM logits
        (tl.sharded_arc_margin_loss(tc, tlab, 0, torch.tensor(margin), 32.0,
                                    easy),
         -np.take_along_axis(np.asarray(jax.nn.log_softmax(
             jl.arc_margin_logits(cos, labels, margin, 32.0, easy), axis=-1)),
             labels[:, None], 1)[:, 0]),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_sharded_loss_refuses_a_second_shard():
    """... without the model axis's process group, which joins the shards
    (``tests/test_torch_sv_train_sharded.py``)."""
    cos, labels = _cosines(0)
    with pytest.raises(ValueError, match="needs the model axis's process "
                                         "group"):
        tl.sharded_arc_margin_loss(torch.from_numpy(cos),
                                   torch.from_numpy(labels), 5, 0.2)


def test_preemption_checkpoint_rewinds_the_epoch(tmp_path):
    counter = tck.EpochCounter(10)
    for _ in range(3):
        next(counter)
    ckpt = tck.Checkpointer(str(tmp_path), {"epoch_counter": counter})
    d = tpre.save_preemption_checkpoint(ckpt, counter, 3,
                                        {"train_state": {"x": np.ones(2)}})
    assert d.endswith("CKPT-EPOCH-2-00")
    fresh = tck.EpochCounter(10)
    tck.Checkpointer(str(tmp_path), {"epoch_counter": fresh}).recover_if_possible()
    assert fresh.current == 2 and next(fresh) == 3
    shutdown = tpre.GracefulShutdown()
    try:
        assert not shutdown.poll()
        os.kill(os.getpid(), signal.SIGTERM)
        assert shutdown.poll()
    finally:
        shutdown.restore()
    shutdown.finalize(preempted=False)  # nothing handled: returns


def test_step_tracer_writes_a_trace(tmp_path):
    tracer = StepTracer(str(tmp_path / "prof"), start_step=1, num_steps=2)
    x = torch.randn(64, 64)
    for step in range(5):
        tracer.before_step(step)
        y = x @ x
        tracer.after_step(step, wait_for=y)
    tracer.close()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
