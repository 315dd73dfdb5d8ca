"""The port's copies of three small public helpers against the JAX
package's: ``utils/misc.py::get_logger`` and ``silent_print``, and
``ops/fbank.py::inverse_mel_scale``."""

import inspect
import logging
import sys

import numpy as np

from speaker3d_tpu.ops import fbank as jfbank
from speaker3d_tpu.utils import misc as jmisc
from speaker3d_tpu_torch.ops import fbank as tfbank
from speaker3d_tpu_torch.utils import misc as tmisc
from tests.torch_threads import cap_torch_threads  # noqa: F401


def test_inverse_mel_scale_equals_jax():
    mel = np.concatenate([np.linspace(0.0, 4000.0, 97), [31.5, 2840.25]])
    got = tfbank.inverse_mel_scale(mel)
    np.testing.assert_array_equal(got, jfbank.inverse_mel_scale(mel))
    assert got.dtype == np.float64
    # the inverse of the port's mel scale
    freq = np.array([0.0, 20.0, 700.0, 7999.0])
    np.testing.assert_allclose(
        tfbank.inverse_mel_scale(tfbank.mel_scale(freq)), freq, atol=1e-9)
    assert tfbank.inverse_mel_scale(1127.0) == jfbank.inverse_mel_scale(1127.0)


def _handlers(logger):
    return [(type(h).__name__, getattr(h, "baseFilename", None),
             getattr(h, "stream", None) is sys.stdout, h.formatter._fmt)
            for h in logger.handlers]


def test_get_logger_equals_jax(tmp_path, capsys):
    fmt = "%(levelname)s|%(message)s"
    for name, path in (("t_port_logger", None),
                       ("t_port_file_logger", str(tmp_path / "a.log"))):
        got = tmisc.get_logger(name, path, fmt=fmt)
        got_handlers = _handlers(got)
        # a second call replaces the handlers, as the JAX function does
        again = tmisc.get_logger(name, path, fmt=fmt)
        assert again is got and len(got.handlers) == len(got_handlers)
        want = jmisc.get_logger(name + "_jax", path, fmt=fmt)
        assert got.level == want.level == logging.INFO
        assert got_handlers == _handlers(want)
        got.info("hello %d", 3)
        for h in got.handlers:
            h.flush()
        assert "INFO|hello 3" in capsys.readouterr().out
        if path:
            assert "INFO|hello 3" in open(path).read()
        for logger in (got, want):
            for h in logger.handlers:
                h.close()
            logger.handlers.clear()
    assert (inspect.signature(tmisc.get_logger).parameters
            == inspect.signature(jmisc.get_logger).parameters)


def test_silent_print_equals_jax(capsys):
    for silent in (tmisc.silent_print, jmisc.silent_print):
        with silent():
            print("hidden")
            print("hidden too", file=sys.stderr)
        print("shown")
        out = capsys.readouterr()
        assert out.out == "shown\n" and out.err == ""
