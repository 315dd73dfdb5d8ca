"""The port's probe tool (K3's plain versions) against the TPU tool's five
Pallas probes, run in interpret mode on the CPU on the same seeded inputs.

a-c must be bit-exact. d and e sum their products in fp32 in another order
and round to bf16, so they may differ by a bf16 rounding step:
|got - want| <= 2^-8 max|want|, and at most 1% of elements differ at all.
"""

import importlib
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from speaker3d_tpu_torch.tools import probe_ops
from tests.torch_threads import cap_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def tpu_probes():
    """{key: (inputs, output)} of the TPU tool's probes, in interpret mode."""
    # the TPU tool puts a fixed directory in front of sys.path when it is
    # imported; keep that out of the rest of the session
    path = sys.path[:]
    try:
        probe_mosaic_ops = importlib.import_module("tools.probe_mosaic_ops")
    finally:
        sys.path[:] = path
    captured = {}

    def run(name, kernel, out_shape, *args, scratch_shapes=()):
        fn = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(out_shape,
                                                   probe_mosaic_ops.DT),
            scratch_shapes=list(scratch_shapes), interpret=True)
        captured[name[0]] = ([np.asarray(a, np.float32) for a in args],
                             np.asarray(fn(*args), np.float32))
        return True

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(probe_mosaic_ops, "run", run)
        probe_mosaic_ops.main()
    assert sorted(captured) == list("abcde")
    return captured


@pytest.mark.parametrize("key", list("abcde"))
def test_plain_probe_matches_tpu_probe(tpu_probes, key):
    args, want = tpu_probes[key]
    probe = probe_ops.PROBES[key]
    ours = probe.args(probe_ops.make_inputs("cpu"))
    for a, b in zip(ours, args):  # the same seeded bf16 inputs
        assert np.array_equal(a.float().numpy(), b)
    launches = probe.run.launches
    got = probe.run(*ours)
    assert probe.run.launches == launches  # CPU: no kernel
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    if key in "abc":
        assert np.array_equal(got, want)
    else:
        diff = np.abs(got - want)
        assert diff.max() <= 2.0 ** -8 * np.abs(want).max()
        assert np.mean(diff > 0) <= 0.01
    assert probe_ops.within_tolerance(key, torch.from_numpy(got),
                                      torch.from_numpy(want))


def test_probe_tool_runs_on_cpu(capsys):
    run = probe_ops.ToolRun()
    launches = probe_ops.probe_all.launches
    assert probe_ops.main(["--device", "cpu"], run) == 0
    assert probe_ops.probe_all.launches == launches  # CPU: no kernel
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1][0] for ln in lines] == list("abcde")
    assert all(ln.startswith("[OK]   ") and "sum=" in ln for ln in lines)
    assert [r.probe.key for r in run.results] == list("abcde")
    assert run.ms is None and not run.error
    for r in run.results:
        assert not r.error
        assert r.max_abs_err == 0 and torch.equal(r.got, r.want)


def test_probe_all_on_cpu_is_the_five_plain_versions():
    inputs = probe_ops.make_inputs("cpu", seed=4)
    outs = probe_ops.probe_all(inputs["x"], inputs["w9"], inputs["w2"])
    assert list(outs) == list("abcde")
    for key, probe in probe_ops.PROBES.items():
        assert torch.equal(outs[key], probe.plain(*probe.args(inputs)))
    with pytest.raises(ValueError):  # the fused wrapper takes CUDA only
        probe_ops.probe_all_cuda(inputs["x"], inputs["w9"], inputs["w2"])


def test_tolerance_rejects_a_wrong_result():
    x = probe_ops.make_inputs("cpu")["x"]
    want = probe_ops.probe_c_plain(x)
    bad = want.clone()
    bad[0, 0, 0] += 1
    assert not probe_ops.within_tolerance("c", bad, want)
    assert probe_ops.within_tolerance("e", want, want)
    assert not probe_ops.within_tolerance("e", want * 1.5, want)
    assert not probe_ops.within_tolerance("a", want, want[:, 1:-1])
