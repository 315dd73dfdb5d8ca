"""The tiny BERT, batches and conversions that the port's semantic parity
tests share (``tests/test_torch_semantic_{bert,step}.py``)."""

import numpy as np
import torch

from speaker3d_tpu.semantic import bert as jbert
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.semantic import bert as tbert

TINY = dict(num_labels=2, vocab_size=50, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2)
TASKS = [("sequence", False), ("token", True)]


def jax_models() -> dict:
    """The JAX ``build_model``'s two heads at TINY, by task."""
    return {task: jbert.build_model(task, **TINY) for task, _ in TASKS}


def batch(rng, token_level, b=8, n=16):
    """tests/test_semantic_bert.py's class-indicative tokens, with rows
    padded to 10-16 tokens."""
    labels_seq = rng.integers(0, 2, b).astype(np.int32)
    ids = rng.integers(10, 50, (b, n)).astype(np.int32)
    for i, y in enumerate(labels_seq):
        if y:
            ids[i, : n // 2] = 7
    mask = np.ones((b, n), np.int32)
    for i, length in enumerate(rng.integers(10, n + 1, b)):
        mask[i, length:] = 0
        ids[i, length:] = 0
    if token_level:
        labels = np.where(ids == 7, 1, 0).astype(np.int32)
        labels[:, -2:] = -100
    else:
        labels = labels_seq
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def jax_logits(model, params, ids, mask):
    """The Flax head's logits as the JAX step computes them."""
    positions = np.broadcast_to(np.arange(ids.shape[-1])[None], ids.shape)
    return np.asarray(model.module.apply(
        {"params": params}, ids, mask, np.zeros_like(ids), positions, None,
        deterministic=True).logits)


def port(task, params):
    """The port's head on the CPU with the Flax ``params``."""
    model = tbert.build_model(task, device="cpu", **TINY)
    model.load_state_dict(state_dict_from_flax({"params": params}),
                          strict=True)
    return model


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}
