"""Host-side helpers (counterpart of ``lp_gnn_tpu/utils/misc.py``)."""
from __future__ import annotations

import logging
import os
import random
from collections import deque
from typing import Sequence

import numpy as np

KNOWN_SUFFIXES = {"mps", "gz", "bas", "tar", "pk", "log", "lp", "sol", "txt",
                  "json", "sort"}


def extract_fn(path: str) -> str:
    """Strip known file suffixes from a basename (reference utils.py:301-309).

    ``a/b/lp_12.mps.gz`` -> ``lp_12``; keeps dots inside the stem.
    """
    parts = os.path.basename(path).split(".")
    return ".".join(p for p in parts if p not in KNOWN_SUFFIXES)


def mkdir_p(path: str) -> None:
    if path:
        os.makedirs(path, exist_ok=True)


def split_idxs_train_val(ngraphs: int, seed: int = 0):
    """70/30 random split; the reference hard-forces seed 0
    (utils.py:256-272), so the indices equal the JAX package's."""
    if seed != 0:
        logging.warning("train/val split seed forced to 0 (reference parity)")
        seed = 0
    ntrain = int(max(ngraphs * 7 / 10, 1))
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(ngraphs)
    return np.sort(idxs[:ntrain]), np.sort(idxs[ntrain:])


def split_out_chunk(fns: Sequence, chunk: str | None = None) -> list:
    """Select the k-th of N chunks ``"k/N"`` of a file list
    (utils.py:662-669); all of it for no chunk."""
    if chunk is None or str(chunk).lower() == "none":
        return list(fns)
    ck, ttl = map(float, chunk.split("/"))
    n = len(fns)
    sta, ed = int(n / ttl * ck), int(n / ttl * (ck + 1))
    return list(fns)[sta:ed]


def increment_path(path: str, exist_ok: bool = False) -> str:
    """runs/exp -> runs/exp2, runs/exp3 ... unless exist_ok (utils.py:532-556)."""
    if os.path.exists(path) and not exist_ok:
        for n in range(2, 9999):
            p = f"{path}{n}"
            if not os.path.exists(p):
                path = p
                break
    return path.rstrip("/") + "/"


def init_seeds(seed: int = 0) -> None:
    random.seed(seed)
    np.random.seed(seed)


class AverageMeter:
    """Sliding-window mean over the last ``window`` updates
    (lp_gnn_tpu/utils/misc.py:46; reference utils.py:881-907)."""

    def __init__(self, window: int = 10):
        self.window = window
        self.reset()

    def reset(self):
        self._buf = deque(maxlen=self.window)

    def update(self, val: float):
        self._buf.append(float(val))

    @property
    def avg(self) -> float:
        return float(np.mean(self._buf)) if self._buf else 0.0
