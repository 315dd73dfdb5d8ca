"""The port's SSL heads and losses against the JAX package's:
ECAPA-TDNN with ``ssl_input_norm`` under the RDINO and SDPN heads
(models/ssl_heads.py; converted weights, eval mode, 2e-5 of the largest
output; a Res2Net scale of 4 keeps the JAX compile short, and
``tests/test_torch_ecapa.py`` holds the SSL backbone at the configs' 8),
each loss of train/ssl_losses.py and its gradient with respect to the
student outputs and the prototypes (1e-5), the cosine schedule (bit for
bit), and the refusal of more than one card (M14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker3d_tpu.models.ecapa_tdnn import ECAPA_TDNN as JaxECAPA
from speaker3d_tpu.models import ssl_heads as jheads
from speaker3d_tpu.train import ssl_losses as jloss
from speaker3d_tpu.train import ssl_train as jtrain
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
from speaker3d_tpu_torch.models import ssl_heads
from speaker3d_tpu_torch.train import ssl_losses
from speaker3d_tpu_torch.train import ssl_train
from tests.test_torch_eres2netv2 import assert_close_scaled, jax_variables
from tests.torch_threads import cap_torch_threads  # noqa: F401

ECAPA = dict(input_size=80, lin_neurons=32, channels=(16, 16, 16, 16, 48),
             res2net_scale=4, ssl_input_norm=True)
RDINO_HEAD = dict(out_dim=64, hidden_dim=32, bottleneck_dim=16, add_dim=24)
SDPN_HEAD = dict(hidden_dim=32, bottleneck_dim=16)


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


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("variant", ["rdino", "sdpn"])
def test_combiner_forward_matches_jax(variant):
    jm, pm = models(variant)
    variables = jax_variables(jm, t=101, seed=31)
    pm.load_state_dict(state_dict_from_flax(variables, like=pm.state_dict()),
                       strict=True)
    pm.eval()
    feats = np.exp(2.0 * np.random.default_rng(32).standard_normal(
        (3, 101, 80))).astype(np.float32)
    want = jax.jit(jm.apply)(variables, feats)
    with torch.inference_mode():
        got = pm(torch.from_numpy(feats))
    for w, g in zip(want, got):
        assert_close_scaled(g.numpy(), np.asarray(w), 2e-5)


@pytest.mark.parametrize("norm_last_layer", [True, False])
def test_rdino_head_matches_jax(norm_last_layer):
    jh = jheads.RDINOHead(norm_last_layer=norm_last_layer, **RDINO_HEAD)
    x = np.random.default_rng(33).standard_normal((5, 32)).astype(np.float32)
    variables = _host(jh.init(jax.random.PRNGKey(4), x))
    head = ssl_heads.RDINOHead(in_dim=32, norm_last_layer=norm_last_layer,
                               **RDINO_HEAD)
    head.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert head.last_layer.weight_g.requires_grad is (not norm_last_layer)
    assert sorted(head.state_dict()) == [
        "add_layer.bias", "add_layer.weight", "last_layer.weight_g",
        "last_layer.weight_v", "mlp.0.bias", "mlp.0.weight", "mlp.2.bias",
        "mlp.2.weight", "mlp.4.bias", "mlp.4.weight"]
    want = jh.apply(variables, x)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    for w, g in zip(want, got):
        assert_close_scaled(g.numpy(), np.asarray(w), 2e-5)


def test_sdpn_head_matches_jax():
    jh = jheads.SDPNHead(**SDPN_HEAD)
    x = np.random.default_rng(34).standard_normal((5, 32)).astype(np.float32)
    variables = _host(jh.init(jax.random.PRNGKey(5), x))
    head = ssl_heads.SDPNHead(in_dim=32, **SDPN_HEAD)
    head.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    assert_close_scaled(got, np.asarray(jh.apply(variables, x)), 2e-5)


def test_heads_initialise_as_truncated_normal_at_two_std():
    gen = torch.Generator().manual_seed(0)
    head = ssl_heads.RDINOHead(in_dim=256, out_dim=4096, hidden_dim=512,
                               bottleneck_dim=256, add_dim=1024,
                               generator=gen)
    w = head.last_layer.weight_v.detach()
    assert float(w.abs().max()) <= 0.04
    assert abs(float(w.std()) - 0.02 * 0.87962566) < 2e-4
    assert torch.all(head.last_layer.weight_g == 1.0)
    assert torch.all(head.mlp[0].bias == 0.0)


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-5, err_msg=what)


def test_dino_and_reg_losses_and_gradients_match_jax():
    rng = np.random.default_rng(40)
    k, ncrops, b = 32, 6, 5
    student = rng.standard_normal((ncrops * b, k)).astype(np.float32)
    teacher = rng.standard_normal((2 * b, k)).astype(np.float32)
    center = 0.1 * rng.standard_normal((1, k)).astype(np.float32)

    def jdino(s):
        return jloss.dino_loss(s, teacher, center, ncrops=ncrops,
                               teacher_temp=0.05)
    (jl, jc), jg = jax.value_and_grad(jdino, has_aux=True)(student)
    s = _t(student, True)
    pl, pc = ssl_losses.dino_loss(s, _t(teacher), _t(center), ncrops=ncrops,
                                  teacher_temp=0.05)
    (pg,) = torch.autograd.grad(pl, s)
    _close(pl.item(), jl, "dino loss")
    _close(pc, jc, "center")
    _close(pg, jg, "dino grad")

    d = 24
    tea = rng.standard_normal((2 * b, d)).astype(np.float32)
    stu = rng.standard_normal((2 * b, d)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda x: jloss.reg_loss(
        tea, x, std_coeff=5.0, cov_coeff=1.0))(stu)
    s = _t(stu, True)
    pl = ssl_losses.reg_loss(_t(tea), s, std_coeff=5.0, cov_coeff=1.0)
    (pg,) = torch.autograd.grad(pl, s)
    _close(pl.item(), jl, "reg loss")
    _close(pg, jg, "reg grad")


def test_sdpn_losses_and_gradients_match_jax():
    rng = np.random.default_rng(41)
    b, d, p = 5, 16, 12
    anchors = rng.standard_normal((4 * b, d)).astype(np.float32)
    targets = rng.standard_normal((b, d)).astype(np.float32)
    protos = rng.standard_normal((p, d)).astype(np.float32)
    labels = np.eye(p, dtype=np.float32)

    def jfn(a, q):
        loss, rloss, _ = jloss.sdpn_loss(a, targets, q, labels)
        return loss + rloss, (loss, rloss)
    (_, (jl, jr)), (ga, gq) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(anchors, protos)
    a, q = _t(anchors, True), _t(protos, True)
    pl, pr, _ = ssl_losses.sdpn_loss(a, _t(targets), q, _t(labels))
    pga, pgq = torch.autograd.grad(pl + pr, (a, q))
    _close(pl.item(), jl, "sdpn loss")
    _close(pr.item(), jr, "memax")
    _close(pga, ga, "anchor grad")
    _close(pgq, gq, "prototype grad")

    probs = np.abs(rng.standard_normal((b, p))).astype(np.float32)
    _close(ssl_losses.sharpen(_t(probs), 0.25),
           jloss.sharpen(jnp.asarray(probs), 0.25), "sharpen")
    _close(ssl_losses.distributed_sinkhorn(_t(probs)),
           jloss.distributed_sinkhorn(jnp.asarray(probs)), "sinkhorn")
    _close(ssl_losses.snn(_t(anchors), _t(protos), _t(labels)),
           jloss.snn(jnp.asarray(anchors), jnp.asarray(protos),
                     jnp.asarray(labels)), "snn")


def test_koleo_loss_and_gradient_match_jax_with_ties():
    rng = np.random.default_rng(42)
    x = rng.standard_normal((10, 8)).astype(np.float32)
    x[7] = x[3]  # an exact tie: the first index wins in both
    x[9] = 2.0 * x[3]
    jl, jg = jax.value_and_grad(jloss.koleo_loss)(x)
    t = _t(x, True)
    pl = ssl_losses.koleo_loss(t)
    (pg,) = torch.autograd.grad(pl, t)
    _close(pl.item(), jl, "koleo")
    _close(pg, jg, "koleo grad")


def test_schedule_matches_jax():
    for kw in (dict(base_value=0.05, final_value=1e-5, total_steps=600,
                    warmup_steps=40),
               dict(base_value=0.996, final_value=1.0, total_steps=450)):
        for step in range(0, 600, 7):
            got = ssl_train.ssl_cosine_schedule(step, **kw).item()
            want = float(jtrain.ssl_cosine_schedule(step, **kw))
            assert got == want, (kw, step, got, want)


def test_more_than_one_card_is_refused_naming_m14():
    x = torch.zeros((4, 8))
    with pytest.raises(NotImplementedError, match="M14"):
        ssl_losses.dino_loss(x, x[:2], torch.zeros((1, 8)), ncrops=2,
                             teacher_temp=0.04, world_size=2)
    with pytest.raises(NotImplementedError, match="M14"):
        ssl_losses.distributed_sinkhorn(x, world_size=4)
