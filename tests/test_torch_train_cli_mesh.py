"""The port's SV trainer CLI on four ``gloo`` ranks.

One module fixture starts the four ranks once (``tests/torch_mesh_worker.py``,
which imports no JAX); each runs ``cli.train.main`` with ``model_parallel:
2``, so a 2 x 2 mesh and 9 classes (3 speakers x 3 speeds) padded to 10.
Rank 0 alone writes the checkpoints and the log lines, the checkpoint holds
the global padded classifier, and one process resumes the four ranks'
experiment for a third epoch, dropping the padded row.
"""

import os

import numpy as np
import pytest

from speaker3d_tpu_torch.cli import train as t_train
from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
from tests.test_torch_train_cli import _config, _corpus, _log
from tests.torch_mesh_worker import run_ranks
from tests.torch_threads import cap_torch_threads  # noqa: F401

EPOCHS = 2


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_mesh"))
    _corpus(root, n_utt=8)
    cfg, exp = _config(root, "exp", model_parallel=2, batch_size=8,
                       num_epoch=EPOCHS, num_workers=2)
    out = run_ranks("train_cli",
                    {"argv": ["--config", cfg, "--device", "cpu"]},
                    os.path.join(root, "ranks"))
    return out["writes"], root, exp


def test_train_cli_on_four_ranks_writes_from_rank_0_and_resumes(
        four_ranks, capsys):
    writes, root, exp = four_ranks
    assert writes[0] == {"save_checkpoint": EPOCHS, "log_stats": EPOCHS}
    assert all(w == {"save_checkpoint": 0, "log_stats": 0}
               for w in writes[1:]), writes
    assert len(_log(exp)) == EPOCHS
    tree = Checkpointer(os.path.join(exp, "models")).recover_if_possible()[
        "train_state"]
    # 9 classes over 2 class shards: one padded row
    assert tree["cls_w"].shape == tree["momentum"]["cls_w"].shape == (10, 32)
    # one process resumes the four ranks' experiment for a third epoch
    cfg, _ = _config(root, "exp", batch_size=8, num_epoch=EPOCHS + 1,
                     num_workers=2)
    t_train.main(["--config", cfg, "--device", "cpu"])
    assert f"recovered from epoch {EPOCHS}" in capsys.readouterr().out
    log = _log(exp)
    assert len(log) == EPOCHS + 1
    assert np.isfinite(float(log[-1]["avg_loss"]))
    last = Checkpointer(os.path.join(exp, "models")).recover_if_possible()[
        "train_state"]
    assert last["cls_w"].shape == (9, 32) and int(last["step"]) > int(
        tree["step"])
