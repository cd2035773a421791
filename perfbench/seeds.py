"""Seeds of a run's parts, derived from ``--seed``.

Every part (each LP's draws, the weights, dropout's generator, the order
of the steps) takes a seed of its own from ``--seed`` and the part's
name, so the same ``--seed`` gives the same inputs and no two parts share
a stream. Any whole number ``>= 0`` is taken, however large.
"""
from __future__ import annotations

import zlib

import numpy as np


def sequence(seed: int, part: str, index: int = 0) -> np.random.SeedSequence:
    """The seed sequence of ``part`` (its ``index``-th one) of a run."""
    if seed < 0:
        raise ValueError(f"--seed must be >= 0, got {seed}")
    return np.random.SeedSequence([seed, zlib.crc32(part.encode()), index])


def derive(seed: int, part: str, index: int = 0) -> int:
    """A 63-bit integer seed of ``part`` (for ``torch.Generator``)."""
    hi, lo = sequence(seed, part, index).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def numpy_rng(seed: int, part: str, index: int = 0) -> np.random.Generator:
    """A numpy generator of ``part``."""
    return np.random.default_rng(sequence(seed, part, index))
