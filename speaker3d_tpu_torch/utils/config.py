"""YAML config with key=value overrides from the command line.

The counterpart of ``speaker3d_tpu/utils/config.py``: a ``Config`` wraps the
YAML dict with attribute and item access; ``--key=value`` (or ``--key
value``) arguments override YAML keys, each value parsed as YAML; the
resolved config is written to ``exp_dir/config.yaml`` for the CLIs that
later load the experiment. It reads the repo's ``configs/*.yaml`` as they
are.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import yaml


class Config:
    """Attribute-accessible config."""

    def __init__(self, entries: Dict[str, Any]):
        self.__dict__.update(entries)

    def __contains__(self, key):
        return key in self.__dict__

    def __getitem__(self, key):
        return self.__dict__[key]

    def __setitem__(self, key, value):
        self.__dict__[key] = value

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


def parse_overrides(overrides: Optional[List[str]]) -> Dict[str, Any]:
    """['--lr=0.1', '--exp_dir', 'exp/foo'] -> {'lr': 0.1, 'exp_dir': 'exp/foo'}."""
    out: Dict[str, Any] = {}
    if not overrides:
        return out
    i = 0
    while i < len(overrides):
        arg = overrides[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected override token {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, raw = key.split("=", 1)
        else:
            i += 1
            if i >= len(overrides):
                raise ValueError(f"missing value for --{key}")
            raw = overrides[i]
        out[key] = yaml.safe_load(raw)
        i += 1
    return out


def build_config(config_file: str, overrides: Optional[List[str]] = None,
                 copy_to_exp_dir: bool = False) -> Config:
    """Load the YAML, apply the overrides, and with ``copy_to_exp_dir``
    write the result to ``exp_dir/config.yaml``."""
    with open(config_file) as f:
        entries = yaml.safe_load(f) or {}
    entries.update(parse_overrides(overrides))
    config = Config(entries)
    if copy_to_exp_dir and "exp_dir" in entries:
        os.makedirs(entries["exp_dir"], exist_ok=True)
        with open(os.path.join(entries["exp_dir"], "config.yaml"), "w") as f:
            yaml.safe_dump(entries, f, sort_keys=False)
    return config
