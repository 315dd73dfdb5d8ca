"""Weights across the two packages: the JAX package's Flax variables -> this
package's state_dict, and torch checkpoint loading.

Flax submodules are named like the reference's torch attribute paths
(``layer1.0.convs.1``), so the conversion is mechanical:

  - Conv kernel HWIO [kH, kW, I, O] -> OIHW [O, I, kH, kW] (WIO -> OIW)
  - Dense kernel [I, O]            -> Linear weight [O, I]
  - Embed embedding [N, D]         -> Embedding weight [N, D] (as it is)
  - BatchNorm scale/bias           -> weight/bias
  - batch_stats mean/var           -> running_mean/running_var (and a zero
    ``num_batches_tracked``, which torch's BatchNorm keeps as a buffer)

Some layers that the JAX modules hold as ``nn.Dense`` are k=1 ``Conv1d``s in
the reference (CAM++'s ``xvector.dense.linear``, ECAPA's ``fc.conv``,
ASTP's ``linear1``/``linear2``, the classifiers' ``blocks.<i>.linear``):
given the port module's state_dict as ``like``, a leaf of the same size is
reshaped to the module's shape, [O, I] -> [O, I, 1]. A raw ``weight``
parameter (``CosineClassifier``) and a weight-normed layer's ``weight_g`` /
``weight_v`` (the SSL heads' ``last_layer``) are already in torch layout
and are copied as they are.

A 3-D convolution's kernel DHWIO [kD, kH, kW, I, O] becomes OIDHW (TalkNet's
``frontend3D.0``). A Flax parameter kept in torch layout under a torch name
(TalkNet's ``in_proj_weight``, ``out_proj.weight``, ``gamma``, ``beta``, the
PReLU's ``net.3.weight``) is copied as it is.

``flax_from_state_dict`` is the inverse for modules whose layer lists are
Flax submodules named ``<name>.{i}`` (the FSMN VAD and segmenter, SAN-M's
``encoders.{i}``), and whose other dotted Flax names are given as
``joined`` (SAN-M's ``feed_forward.w_1``; ECAPA's ``norm.norm``,
``asp_bn.norm``, ``fc.conv``; TalkNet's ``se.fc.0``, ``visualTCN.net.0``),
whose k=1 convs that Flax holds as Dense layers are named in ``dense``
(ECAPA's ``fc.conv``), whose embedding tables are named in ``embed`` (BERT's
``word_embeddings``, ``position_embeddings``, ``token_type_embeddings``),
and whose torch-layout parameters are matched by ``raw`` (TalkNet's): the
port's trainers write their checkpoints in the JAX trainers' layout with
it. A Flax module list nested as ``layer/{i}`` (BERT's encoder) comes out
as ``layer.{i}``; flattened to dotted names the two trees are the same.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "embedding": "weight",  # an Embed table [N, D], as torch's
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "weight": "weight",  # a raw parameter kept in torch layout (CosineClassifier)
    "weight_g": "weight_g",  # weight norm's gain [O, 1] and direction [O, I]
    "weight_v": "weight_v",
    "in_proj_weight": "in_proj_weight",  # MultiheadAttention's, torch layout
    "in_proj_bias": "in_proj_bias",
    "gamma": "gamma",  # TalkNet's GlobalLayerNorm, [1, C, 1]
    "beta": "beta",
}
_RAW_LEAVES = ("weight_g", "weight_v")


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
            # a dotted leaf ('out_proj.weight') is a torch-layout parameter
            tleaf = leaf if "." in leaf else _LEAF_TO_TORCH.get(leaf)
            if tleaf is None:
                raise KeyError(f"no torch mapping for flax leaf {coll}/{path}")
            t = np.asarray(val)
            if leaf == "kernel":
                if t.ndim == 5:
                    t = t.transpose(4, 3, 0, 1, 2)
                elif t.ndim == 4:
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


def _flax_module_path(parts, joined: Sequence[str] = ()):
    """['fsmn', '0', 'proj'] -> ['fsmn.0', 'proj']: an index joins the name
    before it, as in the Flax submodule name ``fsmn.0``; so does a name
    that forms one of ``joined`` with it (['feed_forward', 'w_1'] ->
    ['feed_forward.w_1'] when ``joined`` holds 'feed_forward.w_1')."""
    out = []
    for p in parts:
        if out and (p.isdigit() or f"{out[-1]}.{p}" in joined):
            out[-1] = f"{out[-1]}.{p}"
        else:
            out.append(p)
    return out


def flax_from_state_dict(state_dict: Mapping[str, Any],
                         joined: Sequence[str] = (),
                         dense: Sequence[str] = (),
                         raw: Sequence[str] = (),
                         embed: Sequence[str] = ()) -> dict:
    """A state_dict -> ``{'params'[, 'batch_stats']}`` as nested dicts of
    numpy arrays, the inverse of ``state_dict_from_flax``: a ``weight`` of
    1 dimension is a norm's ``scale``, of 2 a Dense kernel [I, O], of 3 a
    Conv kernel [k, I, O] (a Dense kernel [I, O] where the module's Flax
    name is in ``dense``), of 4 an HWIO kernel and of 5 a DHWIO kernel; a
    ``weight`` of a module whose Flax name is in ``embed`` is an Embed
    table's ``embedding``, as it is;
    ``weight_g`` and ``weight_v`` are copied as they are; ``running_mean``
    and ``running_var`` go to ``batch_stats``; ``num_batches_tracked`` is
    dropped. ``joined``: the Flax submodule names that hold a dot besides
    an index (a model's ``flax_joined_names``). ``raw``: regular
    expressions of whole keys whose one group is a Flax leaf kept in torch
    layout (TalkNet's ``flax_raw_names``): the leaf is copied
    as it is under the module path before it."""
    out: dict = {}
    for key, val in state_dict.items():
        match = next((m for m in (re.fullmatch(r, key) for r in raw) if m),
                     None)
        if match is not None:
            mods, leaf = key[:match.start(1) - 1].split("."), match.group(1)
        else:
            *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        t = np.array(val.detach().cpu().numpy()
                     if isinstance(val, torch.Tensor) else val)
        coll = "params"
        path = _flax_module_path(mods, joined)
        if match is not None or leaf in _RAW_LEAVES:
            pass
        elif leaf == "weight" and path and path[-1] in embed:
            leaf = "embedding"
        elif leaf == "weight":
            if t.ndim == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                # OIHW -> HWIO, OIDHW -> DHWIO; OI -> IO and OIW -> WIO
                t = (t.transpose(2, 3, 1, 0) if t.ndim == 4
                     else t.transpose(2, 3, 4, 1, 0) if t.ndim == 5
                     else t.transpose(tuple(range(t.ndim))[::-1]))
                if t.ndim == 3 and path and path[-1] in dense:
                    t = t.reshape(t.shape[1:])  # [1, I, O] -> [I, O]
        elif leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf != "bias":
            raise KeyError(f"no flax mapping for torch leaf {key}")
        node = out.setdefault(coll, {})
        for m in path:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(t)
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
