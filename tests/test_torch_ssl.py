"""Three train steps of each SSL variant (train/ssl_train.py) through the
mel feature path (ops/melspec.py), the port's against the JAX package's;
``test_torch_ssl_losses.py`` holds the heads and the losses.

The JAX steps run as the JAX package's own tests run them, on a one-device
mesh. Both packages start from one JAX ``init_ssl_state``, which crosses
over through the port's ``load_state_tree``, and take three steps (B = 4,
``step_per_epoch = 2``, ``freeze_last_layer = 1``: the last layer is frozen
for two steps and free in the third). The backbone is ECAPA-TDNN at
channels (16, 16, 16, 16, 48) with a Res2Net scale of 4 (the configs' 8
would double the JAX step's compile time; ``test_torch_ssl_losses.py``
holds the forward at scale 8).

- In float64 (the JAX step under ``jax.enable_x64``, the port's modules
  in double) the port's ``state_tree`` is held against the JAX state leaf
  by leaf within 1e-7 of max(max|want|, 0.01), and the losses within 1e-7. The floor covers leaves
  that start at 0 and stay near it, such as ``asp.conv``'s bias, whose
  gradient is zero but for rounding in both packages (the attention
  softmax over time removes it).
- In float32, the port's fp32 path, the three losses are held against the
  JAX float64 losses within 1e-4. Its state is not compared leaf by leaf:
  on random ECAPA weights the backward of training-mode BatchNorm cancels
  (it subtracts the incoming gradient's components along the batch mean
  and the normalised input, nearly all of it here), so that the port's own
  fp32 gradient of some conv and BatchNorm leaves lies up to 7% of that
  leaf's size from its float64 gradient while the loss agrees to 1e-6
  (at the chip check's width 128 still 1-2%: a linear functional of the
  embedding has a gradient error of 1e-4 at ``blocks.3``'s input and 2e-2
  at ``blocks.2``'s). The JAX package's fp32 step lies as far from its
  own float64 step. The card's fp32 step is held against the CPU's in
  ``chip_smoke.py``.

The port's steps run at 2 CPU threads (``utils/threads.py``): torch's CPU
conv weight gradient sums in an order that depends on the thread count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from speaker3d_tpu.models.ecapa_tdnn import ECAPA_TDNN as JaxECAPA
from speaker3d_tpu.models import ssl_heads as jheads
from speaker3d_tpu.ops.melspec import MelSpecConfig as JaxMelCfg
from speaker3d_tpu.ops.melspec import MelSpectrogram as JaxMel
from speaker3d_tpu.parallel.mesh import make_mesh
from speaker3d_tpu.train import ssl_train as jtrain
from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
from speaker3d_tpu_torch.models import ssl_heads
from speaker3d_tpu_torch.ops.melspec import MelSpecConfig, MelSpectrogram
from speaker3d_tpu_torch.train import ssl_train
from speaker3d_tpu_torch.utils.threads import cpu_threads
from tests.torch_threads import cap_torch_threads  # noqa: F401

ECAPA = dict(input_size=80, lin_neurons=32, channels=(16, 16, 16, 16, 48),
             res2net_scale=4, ssl_input_norm=True)
RDINO_HEAD = dict(out_dim=64, hidden_dim=32, bottleneck_dim=16, add_dim=24)
SDPN_HEAD = dict(hidden_dim=32, bottleneck_dim=16)
B = 4
STEPS = 3
PORT_THREADS = 2
TOL = 1e-4
TOL64 = 1e-7


def models(variant):
    """(JAX combiner, port combiner) at the small widths."""
    if variant == "rdino":
        return (jheads.RDINOCombiner(backbone=JaxECAPA(**ECAPA),
                                     head=jheads.RDINOHead(**RDINO_HEAD)),
                ssl_heads.RDINOCombiner(ECAPA_TDNN(**ECAPA),
                                        ssl_heads.RDINOHead(in_dim=32,
                                                            **RDINO_HEAD)))
    return (jheads.SDPNCombiner(backbone=JaxECAPA(**ECAPA),
                                head=jheads.SDPNHead(**SDPN_HEAD)),
            ssl_heads.SDPNCombiner(ECAPA_TDNN(**ECAPA),
                                   ssl_heads.SDPNHead(in_dim=32,
                                                      **SDPN_HEAD)))


def train_config(variant):
    common = dict(base_lr=0.01, epochs=3, step_per_epoch=2, warmup_epochs=1,
                  freeze_last_layer=1)
    if variant == "rdino":
        return jtrain.SSLTrainConfig(out_dim=64, ncrops=6, **common)
    return jtrain.SSLTrainConfig(num_proto=12, output_dim=16,
                                 num_local_views=4, **common)


def batches(variant):
    g = 2 if variant == "rdino" else 1
    rng = np.random.default_rng(21 if variant == "rdino" else 22)
    return [{"global_wavs": (0.1 * rng.standard_normal((B, g, 16000))
                             ).astype(np.float32),
             "local_wavs": (0.1 * rng.standard_normal((B, 4, 8000))
                            ).astype(np.float32)} for _ in range(STEPS)]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


def _port_steps(variant, pm, cfg, init, dtype):
    """(losses, state) of the port's three steps from ``init``."""
    pcfg = ssl_train.SSLTrainConfig(**cfg._asdict())
    pstate = ssl_train.init_ssl_state(pm.to(dtype), pcfg, variant, "cpu")
    ssl_train.load_state_tree(pstate, init)
    make = (ssl_train.make_rdino_train_step if variant == "rdino"
            else ssl_train.make_sdpn_train_step)
    pstep = make(pcfg, feature_fn=MelSpectrogram(MelSpecConfig(),
                                                 device="cpu", dtype=dtype))
    losses = []
    with cpu_threads(PORT_THREADS):
        for batch in batches(variant):
            metrics = pstep(pstate, {k: torch.from_numpy(v).to(dtype)
                                     for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
    return losses, pstate


@pytest.fixture(scope="module", params=["rdino", "sdpn"])
def runs(request):
    """Both packages' three steps from one JAX init: the JAX step in
    float64, the port's in float64 and in float32."""
    variant = request.param
    jm, pm = models(variant)
    cfg = train_config(variant)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    state = jtrain.init_ssl_state(jax.random.PRNGKey(3), jm,
                                  np.zeros((1, 101, 80), np.float32), cfg,
                                  mesh, variant)
    init = _host(state)
    make = (jtrain.make_rdino_train_step if variant == "rdino"
            else jtrain.make_sdpn_train_step)
    with jax.enable_x64(True):
        state = jax.device_put(_f64(init), NamedSharding(mesh, P()))
        step = make(jm, cfg, mesh, _f64(init),
                    feature_fn=JaxMel(JaxMelCfg(), dtype=jnp.float64))
        jax_losses = []
        for batch in batches(variant):
            state, metrics = step(state, _f64(batch))
            jax_losses.append(float(metrics["loss"]))
        want = _host(state)

    losses64, pstate64 = _port_steps(variant, pm, cfg, init, torch.float64)
    got = ssl_train.state_tree(pstate64)
    _, pm32 = models(variant)
    losses32, pstate32 = _port_steps(variant, pm32, cfg, init, torch.float32)
    return {"variant": variant, "init": init, "want": want, "got": got,
            "round_trip": ssl_train.state_tree(
                _loaded(variant, cfg, init)),
            "jax_losses": jax_losses, "port_losses64": losses64,
            "port_losses32": losses32, "got32": ssl_train.state_tree(pstate32)}


def _loaded(variant, cfg, init):
    _, pm = models(variant)
    pstate = ssl_train.init_ssl_state(
        pm, ssl_train.SSLTrainConfig(**cfg._asdict()), variant, "cpu")
    ssl_train.load_state_tree(pstate, init)
    return pstate


def _leaves(tree):
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_state_tree_round_trips_the_jax_ssl_state(runs):
    """load_state_tree then state_tree gives back the JAX trainer's
    ssl_state: the same keys, shapes, dtypes and values."""
    want, got = _leaves(runs["init"]), _leaves(runs["round_trip"])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_three_steps_match_the_jax_steps(runs):
    """float64: every leaf of the state within 1e-7 of its scale, and the
    losses; float32: the losses within 1e-4 of the JAX float64 ones."""
    np.testing.assert_allclose(runs["port_losses64"], runs["jax_losses"],
                               rtol=TOL64, atol=TOL64)
    np.testing.assert_allclose(runs["port_losses32"], runs["jax_losses"],
                               rtol=TOL, atol=TOL)
    want, got = _leaves(runs["want"]), _leaves(runs["got"])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(want, got):
        scale = max(float(np.abs(a).max()), 0.01)
        assert np.abs(a - b).max() <= TOL64 * scale, (k, np.abs(a - b).max(),
                                                      scale)
    assert int(runs["got"]["step"]) == int(runs["got32"]["step"]) == STEPS


def test_frozen_last_layer_and_prototypes_update_as_the_jax_step(runs):
    """RDINO: the traps the port copies. The frozen weight_g [out, 1] is
    2-D, so the decay shrinks it although its gradient is 0, and weight_v
    moves in the frozen steps by its decay and momentum. SDPN: the
    prototypes, a group of their own (no decay, no clip), move by their
    own lr times their momentum."""
    got, want, init = runs["got32"], runs["want"], runs["init"]
    if runs["variant"] == "rdino":
        for tree in (want, runs["got"], got):
            g = tree["student"]["params"]["head"]["last_layer"]["weight_g"]
            assert np.all(g < 1.0) and np.all(g > 0.9999), g.ravel()[:4]
        last = init["student"]["params"]["head"]["last_layer"]
        moved = got["student"]["params"]["head"]["last_layer"]
        assert np.abs(moved["weight_v"] - last["weight_v"]).max() > 0
        np.testing.assert_allclose(
            moved["weight_g"],
            want["student"]["params"]["head"]["last_layer"]["weight_g"],
            rtol=0, atol=1e-7)
    else:
        assert np.abs(got["prototypes"] - init["prototypes"]).max() > 0
        np.testing.assert_allclose(got["prototypes"], want["prototypes"],
                                   rtol=0, atol=TOL * max(
                                       np.abs(want["prototypes"]).max(), 0.01))
        np.testing.assert_allclose(got["proto_momentum"],
                                   want["proto_momentum"], rtol=0, atol=TOL
                                   * np.abs(want["proto_momentum"]).max())
