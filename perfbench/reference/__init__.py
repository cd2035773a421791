"""The plain references, one module a model family (``gcn_fc.py``),
found by the configuration's ``family``: each gives
``param_spec(cfg)`` and ``forward(P, graph, cfg, dropout, rnd)``;
``common.py`` holds what they share. Plain PyTorch; nothing here imports
the program."""
from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of a model family."""
    return importlib.import_module(f"{__name__}.{name}")
