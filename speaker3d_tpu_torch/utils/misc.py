"""Small shared utilities: seeding, logging, meters, map helpers.

The counterpart of ``speaker3d_tpu/utils/misc.py``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import sys
from typing import Dict, Optional

import numpy as np
import torch


def set_seed(seed: int = 1234):
    random.seed(seed)
    np.random.seed(seed)


def get_logger(name: str = "speaker3d_tpu", fpath: Optional[str] = None,
               fmt: str = "%(asctime)s [%(levelname)s] %(message)s"):
    """The named logger at INFO with its handlers replaced: one to stdout
    and, with ``fpath``, one to that file, both in ``fmt``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    formatter = logging.Formatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(formatter)
    logger.addHandler(sh)
    if fpath:
        fh = logging.FileHandler(fpath)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


@contextlib.contextmanager
def silent_print():
    """Suppress stdout and stderr within the block (for noisy third-party
    model loads)."""
    with open(os.devnull, "w") as devnull:
        with contextlib.redirect_stdout(devnull), \
                contextlib.redirect_stderr(devnull):
            yield


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class AverageMeters:
    """Named collection of AverageMeter."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    def update(self, name: str, val, n: int = 1, fmt: str = ":f"):
        if name not in self.meters:
            self.meters[name] = AverageMeter(name, fmt)
        self.meters[name].update(val, n)

    def avg(self, name: str):
        return self.meters[name].avg

    def __str__(self):
        return "  ".join(str(m) for m in self.meters.values())


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        num_digits = len(str(num_batches // 1))
        self.batch_fmtstr = "[{:" + str(num_digits) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in (
            self.meters.meters.values() if isinstance(self.meters, AverageMeters)
            else self.meters)]
        line = "\t".join(entries)
        print(line)
        return line


def utt2spk_to_spk2utt(utt2spk: Dict[str, str]) -> Dict[str, list]:
    out: Dict[str, list] = {}
    for utt, spk in utt2spk.items():
        out.setdefault(spk, []).append(utt)
    return out


def fetch_mean(scalars) -> float:
    """Mean of a list of 0-d tensors (or numbers) with one device-to-host
    copy: stacked on their device first, instead of one sync per element."""
    if not scalars:
        raise ValueError("fetch_mean of empty list")
    stacked = torch.stack([torch.as_tensor(x) for x in scalars])
    return float(stacked.cpu().numpy().mean())
