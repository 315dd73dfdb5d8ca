"""Weights across the two packages: the JAX package's Flax variables -> this
package's state_dict, and torch checkpoint loading.

Flax submodules are named like the reference's torch attribute paths
(``layer1.0.convs.1``), so the conversion is mechanical:

  - Conv kernel HWIO [kH, kW, I, O] -> OIHW [O, I, kH, kW] (WIO -> OIW)
  - Dense kernel [I, O]            -> Linear weight [O, I]
  - BatchNorm scale/bias           -> weight/bias
  - batch_stats mean/var           -> running_mean/running_var (and a zero
    ``num_batches_tracked``, which torch's BatchNorm keeps as a buffer)

Some layers that the JAX modules hold as ``nn.Dense`` are k=1 ``Conv1d``s in
the reference (CAM++'s ``xvector.dense.linear``, ECAPA's ``fc.conv``,
ASTP's ``linear1``/``linear2``, the classifiers' ``blocks.<i>.linear``):
given the port module's state_dict as ``like``, a leaf of the same size is
reshaped to the module's shape, [O, I] -> [O, I, 1]. A raw ``weight``
parameter (``CosineClassifier``) is already in torch layout and is copied
as it is.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "weight": "weight",  # a raw parameter kept in torch layout (CosineClassifier)
}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables: Mapping[str, Any],
                         like: Optional[Mapping[str, Any]] = None) -> dict:
    """``{'params', 'batch_stats'}`` as nested dicts of numpy arrays -> a
    state_dict of tensors for this package's modules (``strict=True``).

    ``like``: the target module's state_dict. A leaf whose shape differs
    from its entry there is reshaped when the sizes agree, and raises
    ``ValueError`` when they do not; keys missing from ``like`` are left to
    ``load_state_dict`` to report."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, val in _flatten(variables.get(coll, {})):
            *mods, leaf = path
            tleaf = _LEAF_TO_TORCH.get(leaf)
            if tleaf is None:
                raise KeyError(f"no torch mapping for flax leaf {coll}/{path}")
            t = np.asarray(val)
            if leaf == "kernel":
                if t.ndim == 4:
                    t = t.transpose(3, 2, 0, 1)
                elif t.ndim == 3:
                    t = t.transpose(2, 1, 0)
                elif t.ndim == 2:
                    t = t.T
            key = ".".join(mods + [tleaf])
            if like is not None and key in like:
                shape = tuple(like[key].shape)
                if t.shape != shape:
                    if t.size != int(np.prod(shape)):
                        raise ValueError(f"{key}: converted shape {t.shape} "
                                         f"does not fit the module's {shape}")
                    t = t.reshape(shape)
            out[key] = torch.tensor(t)  # a copy: JAX-backed arrays are read-only
            if tleaf == "running_mean":
                out[key[:-len("running_mean")] + "num_batches_tracked"] = (
                    torch.tensor(0, dtype=torch.long))
    return out


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> dict:
    """Drop a leading 'module.' from DDP-saved checkpoints."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> dict:
    """A torch .pt/.bin/.ckpt checkpoint -> a plain dict of CPU tensors
    (``state_dict`` unwrapped, ``module.`` stripped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in strip_ddp_prefix(sd).items()
            if isinstance(v, torch.Tensor)}
