"""Trial scoring and embedding stores.

The counterpart of ``speaker3d_tpu/eval/scoring.py`` (reference:
speakerlab/bin/compute_score_metrics.py): per-trial cosine between enrol and
test embeddings, embedding archives as .npz ({utt_id: [D]}), Kaldi ark/scp
or a directory of per-utterance .npy files, and the all-pairs cosine as one
product on the card.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision
from speaker3d_tpu_torch.parallel.mesh import all_gather, data_sharded, shard
from speaker3d_tpu_torch.utils.kaldi_ark import read_ark, read_scp


def save_embeddings(path: str, embeddings: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in embeddings.items()})


def load_embeddings(path_or_dir: str) -> Dict[str, np.ndarray]:
    """Load one .npz, a Kaldi .ark/.scp, every *.npz / *.ark in a
    directory, or a directory of per-utterance <utt>.npy files."""
    if path_or_dir.endswith(".scp"):
        return read_scp(path_or_dir)
    if path_or_dir.endswith(".ark"):
        return read_ark(path_or_dir)
    paths = [path_or_dir]
    if os.path.isdir(path_or_dir):
        entries = sorted(os.listdir(path_or_dir))
        paths = [os.path.join(path_or_dir, p) for p in entries
                 if re.search(r"\.npz$", p)]
        arks = [os.path.join(path_or_dir, p) for p in entries
                if p.endswith(".ark")]
        if not paths and arks:
            out: Dict[str, np.ndarray] = {}
            for p in arks:
                out.update(read_ark(p))
            return out
        if not paths:
            npys = [p for p in entries if p.endswith(".npy")]
            if npys:
                return {p[:-4]: np.load(os.path.join(path_or_dir, p))
                        for p in npys}
            raise FileNotFoundError(
                f"no .npz/.ark/.npy embedding files in {path_or_dir}")
    out = {}
    for p in paths:
        with np.load(p) as data:
            for k in data.files:
                out[k] = data[k]
    return out


def load_trials(path: str) -> List[Tuple[str, str, int]]:
    """Lines: `enrol test {1|0|target|nontarget}`."""
    trials = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            lab = parts[2]
            if lab in ("1", "target"):
                y = 1
            elif lab in ("0", "nontarget"):
                y = 0
            else:
                raise ValueError(f"unrecognized label in line: {line!r}")
            trials.append((parts[0], parts[1], y))
    return trials


def score_trials(enrol: Dict[str, np.ndarray], test: Dict[str, np.ndarray],
                 trials: Sequence[Tuple[str, str, int]], *,
                 device=DEFAULT_DEVICE):
    """Cosine per trial in float64 -> (scores [N], labels [N]) as numpy.

    On the CPU numpy computes it exactly as the JAX package does, and
    ``tests/test_torch_sv.py`` holds the two arrays equal; torch's float64
    norm and sum take their terms in another order and differ in the last
    bits for most trials, so the CPU keeps numpy. On a CUDA device the same
    float64 arithmetic runs on the card, within a few ulps of the host."""
    dev = resolve_device(device)
    e_keys = sorted({t[0] for t in trials})
    t_keys = sorted({t[1] for t in trials})
    e_idx = {k: i for i, k in enumerate(e_keys)}
    t_idx = {k: i for i, k in enumerate(t_keys)}
    E = np.stack([enrol[k] for k in e_keys]).astype(np.float64)
    T = np.stack([test[k] for k in t_keys]).astype(np.float64)
    ei = np.asarray([e_idx[t[0]] for t in trials])
    ti = np.asarray([t_idx[t[1]] for t in trials])
    labels = np.asarray([t[2] for t in trials])
    if dev.type == "cpu":
        E /= np.maximum(np.linalg.norm(E, axis=1, keepdims=True), 1e-12)
        T /= np.maximum(np.linalg.norm(T, axis=1, keepdims=True), 1e-12)
        return np.sum(E[ei] * T[ti], axis=1), labels
    e = torch.nn.functional.normalize(torch.from_numpy(E).to(dev), dim=1,
                                      eps=1e-12)
    t = torch.nn.functional.normalize(torch.from_numpy(T).to(dev), dim=1,
                                      eps=1e-12)
    scores = (e[torch.from_numpy(ei).to(dev)]
              * t[torch.from_numpy(ti).to(dev)]).sum(dim=1)
    return scores.cpu().numpy(), labels


def pairwise_cosine_device(emb: np.ndarray, mesh=None, *,
                           device=DEFAULT_DEVICE) -> np.ndarray:
    """All-pairs cosine as one fp32 product on ``device``, TF32 off (the
    JAX function's ``Precision.HIGHEST``). With a ``mesh`` (every rank
    calls with the same ``emb``) the rows, padded with zeros to a multiple
    of the data axis, are split over ``data``: each rank multiplies its
    row block by the whole on the mesh's device and the blocks are
    gathered to every rank."""
    dev = resolve_device(device) if mesh is None else mesh.device
    x = torch.as_tensor(np.asarray(emb, np.float32), device=dev)
    x = torch.nn.functional.normalize(x, dim=1, eps=1e-12)
    if mesh is None:
        with matmul_precision("highest"):
            return (x @ x.T).cpu().numpy()
    n = x.shape[0]
    x = torch.nn.functional.pad(x, (0, 0, 0, (-n) % mesh.shape["data"]))
    with matmul_precision("highest"):
        rows = shard(x, data_sharded(mesh, 2)) @ x.T
    return all_gather(rows, mesh, "data")[:n, :n].cpu().numpy()
