"""Recursive object builder from config entries.

The counterpart of ``speaker3d_tpu/utils/builder.py``: entries of the form
``{obj: 'dotted.path.Class', args: {...}}`` are built recursively; a
``<name>`` string refers to another config entry (with cycle detection),
also inside a longer string (``'<exp_dir>/models'``).

The repo's configs name the JAX package's classes
(``speaker3d_tpu.models.eres2netv2.ERes2NetV2``). ``dynamic_import`` maps a
path under ``speaker3d_tpu.`` to the same path under
``speaker3d_tpu_torch.``, whose constructors take the same argument names,
and never imports the JAX package. A class the port does not have yet stops
with an error naming its ROADMAP.md item.
"""

from __future__ import annotations

import importlib
import re
from typing import Any

_REF_RE = re.compile(r"<([^<>]+)>")
_JAX_PKG = "speaker3d_tpu."
_PORT_PKG = "speaker3d_tpu_torch."

# JAX modules a config can name that the port has not ported yet, and the
# ROADMAP.md item that ports them (every model module is ported)
NOT_PORTED: dict = {}


def port_path(path: str) -> str:
    """'speaker3d_tpu.x.Y' -> 'speaker3d_tpu_torch.x.Y'; other paths as
    they are."""
    if path.startswith(_JAX_PKG):
        return _PORT_PKG + path[len(_JAX_PKG):]
    return path


def dynamic_import(path: str):
    """'pkg.mod.Attr' -> the attribute, a JAX package path mapped to the
    port's module of the same path."""
    module_name, attr = port_path(path).rsplit(".", 1)
    if module_name in NOT_PORTED:
        raise NotImplementedError(
            f"{path}: not ported to the PyTorch package yet "
            f"(ROADMAP.md Queue 1, {NOT_PORTED[module_name]})")
    module = importlib.import_module(module_name)
    if not hasattr(module, attr):
        raise NotImplementedError(
            f"{path}: {module_name} has no {attr!r}; not ported to the "
            f"PyTorch package yet (ROADMAP.md Queue 1)")
    return getattr(module, attr)


def is_ref_str(value: Any) -> bool:
    return isinstance(value, str) and _REF_RE.search(value) is not None


class Builder:
    def __init__(self, config):
        self.config = config
        self._cache: dict = {}
        self._building: set = set()

    def build(self, name: str):
        """Build (with caching) the config entry ``name``."""
        if name in self._cache:
            return self._cache[name]
        if name in self._building:
            raise ValueError(f"circular reference detected while building {name!r}")
        self._building.add(name)
        try:
            spec = self.config[name] if not hasattr(self.config, "get") \
                else self.config.get(name)
            if spec is None:
                raise KeyError(f"no config entry named {name!r}")
            obj = self._deep_build(spec)
        finally:
            self._building.discard(name)
        self._cache[name] = obj
        return obj

    def _resolve_str(self, value: str):
        m = _REF_RE.fullmatch(value)
        if m:  # whole-string reference -> the built object itself
            return self.build(m.group(1))

        def sub(match):  # reference embedded in a longer string -> str()
            return str(self.build(match.group(1)))

        return _REF_RE.sub(sub, value)

    def _deep_build(self, spec: Any):
        if isinstance(spec, dict) and "obj" in spec:
            cls = dynamic_import(spec["obj"])
            args = {k: self._deep_build(v)
                    for k, v in (spec.get("args") or {}).items()}
            return cls(**args)
        if isinstance(spec, dict):
            return {k: self._deep_build(v) for k, v in spec.items()}
        if isinstance(spec, (list, tuple)):
            return type(spec)(self._deep_build(v) for v in spec)
        if is_ref_str(spec):
            return self._resolve_str(spec)
        return spec


def build(name: str, config) -> Any:
    """One-shot build (no cross-call caching)."""
    return Builder(config).build(name)
