"""One rank of a ``gloo`` process group for the port's mesh tests.

    python -m tests.torch_mesh_worker SCENARIO IN.pkl OUT_DIR RANK WORLD PORT

``run_ranks``, called in the test process (which runs JAX), writes the
inputs as a pickle of numpy arrays, starts WORLD of these processes and
returns what rank 0 wrote to OUT_DIR. This module imports neither ``jax`` nor ``speaker3d_tpu``
(``tests/test_torch_isolation.py``), so each rank starts in a few seconds
and computes only with the port. Scenarios:

- ``sv_train``: the SV train step in float64 on each mesh of ``meshes``
  from the same converted weights and global ``cls_w``, three steps on this
  rank's rows of the global feature batches; rank 0 writes the metrics, the
  JAX-layout tree (the class shards gathered) and a checkpoint. Then
  ``sharded_arc_margin_loss`` on the (1, WORLD) mesh: values and this
  rank's cosine gradients, gathered.
- ``train_cli``: ``cli.train.main(argv)`` on every rank: what each rank
  wrote (checkpoints, log lines), gathered.
- ``embed``: ``build_sharded_embedding_fn`` and ``pairwise_cosine_device``
  on each mesh of ``meshes``.
"""

import os
import pickle
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 2  # torch's threads per rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(scenario: str, inp: dict, out_dir: str, world: int = 4,
              timeout: float = 300.0) -> dict:
    """Start ``world`` ranks of ``scenario`` on ``inp``; rank 0's output.
    ``timeout`` bounds a hung collective (a loaded host slows the ranks
    several times over)."""
    os.makedirs(out_dir, exist_ok=True)
    in_path = os.path.join(out_dir, "in.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inp, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(THREADS))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_mesh_worker", scenario, in_path,
         out_dir, str(r), str(world), str(port)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(
            f"rank {r} rc {p.returncode}:\n{log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    with open(os.path.join(out_dir, "out.pkl"), "rb") as f:
        return pickle.load(f)


def _sv_train(inp, out_dir, rank, world):
    from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
    from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
    from speaker3d_tpu_torch.parallel.mesh import (
        Placement, all_gather, data_sharded, make_mesh, shard)
    from speaker3d_tpu_torch.train import sv_train as tsv
    from speaker3d_tpu_torch.train.losses import sharded_arc_margin_loss
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer

    out = {}
    for shape in inp["meshes"]:
        mesh = make_mesh(*shape, device="cpu")
        model = ERes2NetV2(**inp["small"]).double()
        model.load_state_dict(state_dict_from_flax(
            {"params": inp["params"], "batch_stats": inp["batch_stats"]}),
            strict=True)
        cfg = tsv.SVTrainConfig(**inp["sched"])
        state = tsv.init_sv_train_state(
            model, cfg, cls_w=torch.from_numpy(inp["cls_w"]), mesh=mesh)
        state.step = int(inp["step"])
        step = tsv.make_sv_train_step(model, cfg, mesh=mesh)
        metrics = []
        for batch in inp["batches"]:
            local = {k: shard(torch.from_numpy(v), data_sharded(mesh, v.ndim))
                     for k, v in batch.items()}
            m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
        tree = tsv.flax_state_tree(state)
        own = tsv.state_tree(state)
        if rank == 0:
            ckpt = Checkpointer(os.path.join(out_dir, f"ckpt_{shape[0]}x"
                                             f"{shape[1]}"))
            ckpt.save_checkpoint(0, {"train_state": tree})
            out[tuple(shape)] = {
                "metrics": metrics, "tree": tree, "own": own,
                "local_cls_rows": int(state.cls_w.shape[0]),
                "specs": tsv.state_specs(state)}

    # the vocab-parallel loss on the (1, world) mesh
    loss = inp["loss"]
    mesh = make_mesh(1, world, device="cpu")
    cos = shard(torch.from_numpy(loss["cos"]), Placement(mesh, (None, "model")))
    cos.requires_grad_(True)
    labels = torch.from_numpy(loss["labels"])
    offset = mesh.index("model") * cos.shape[1]
    ce = sharded_arc_margin_loss(cos, labels, offset, loss["margin"],
                                 group=mesh.group("model"))
    total = ce.sum() / (cos.shape[0] * mesh.shape["model"])
    (grad,) = torch.autograd.grad(total, [cos])
    grad = all_gather(grad, mesh, "model", dim=1)
    if rank == 0:
        out["loss"] = {"ce": ce.detach().numpy(), "grad": grad.numpy()}
    return out


def _train_cli(inp, out_dir, rank, world):
    """``cli.train.main(inp['argv'])`` in this rank's process group; each
    rank's count of checkpoint saves and log lines, gathered."""
    from speaker3d_tpu_torch.cli import train
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer, EpochLogger

    calls = {"save_checkpoint": 0, "log_stats": 0}
    saved = Checkpointer.save_checkpoint, EpochLogger.log_stats

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    Checkpointer.save_checkpoint = counting("save_checkpoint", saved[0])
    EpochLogger.log_stats = counting("log_stats", saved[1])
    try:
        train.main(inp["argv"])
    finally:
        Checkpointer.save_checkpoint, EpochLogger.log_stats = saved
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, calls)
    return {"writes": gathered}


def _embed(inp, out_dir, rank, world):
    from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
    from speaker3d_tpu_torch.eval.embedding import build_sharded_embedding_fn
    from speaker3d_tpu_torch.eval.scoring import pairwise_cosine_device
    from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
    from speaker3d_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for shape in inp["meshes"]:
        mesh = make_mesh(*shape, device="cpu")
        model = ERes2NetV2(**inp["small"])
        state = state_dict_from_flax(inp["variables"])
        embed = build_sharded_embedding_fn(model, state, mesh)
        emb = embed(inp["wavs"]).numpy()
        aff = pairwise_cosine_device(inp["emb"], mesh=mesh)
        if rank == 0:
            out[tuple(shape)] = {"emb": emb, "aff": aff}
    return out


SCENARIOS = {"sv_train": _sv_train, "train_cli": _train_cli,
             "embed": _embed}


def main(argv):
    scenario, in_path, out_dir, rank, world, port = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(THREADS)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost

    assert init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    out = SCENARIOS[scenario](inp, out_dir, rank, world)
    torch.distributed.barrier()
    if rank == 0:
        with open(os.path.join(out_dir, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    # no import of JAX happened in this process
    assert "jax" not in sys.modules and "speaker3d_tpu" not in sys.modules


if __name__ == "__main__":
    main(sys.argv[1:])
