"""Counts of the work a training step needs, from shapes: the bytes of
each kernel's calls (``<kind>.py``, by the traversal's ``kind``: ``spmm.py``)
and the traversals and operations of each model family's step
(``<family>.py``, by the configuration's ``family``: ``gcn_fc.py``).

Bytes count each input byte read once and each output byte written once,
the bound column of PERF.md's kernel table. Operations: a GEMM 2 rows in
out forward, as much again for its weights' gradient and again for its
input's where the input needs one; an aggregation 2 E D a traversal.
Only the traversals a step needs count: neither the input conv's cached
aggregations (made once a graph) nor remat's recompute.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class Shape:
    """What the counts read of an LP: its sizes and how many constraints
    and variables have an edge (the rows an aggregation reads)."""
    ncons: int
    nvars: int
    nnz: int
    cons_used: int
    vars_used: int

    @classmethod
    def of(cls, lp) -> "Shape":
        return cls(lp.ncons, lp.nvars, lp.nnz,
                   int(np.count_nonzero(np.bincount(lp.row,
                                                    minlength=lp.ncons))),
                   int(np.count_nonzero(np.bincount(lp.col,
                                                    minlength=lp.nvars))))


@dataclasses.dataclass(frozen=True)
class Traversal:
    """One pass of a kernel over a graph's edges: ``kind`` (the count
    module of its kernel, ``spmm``), its destination and source node
    counts (sources: those with an edge), its width and element bytes."""
    kind: str
    n_dst: int
    n_src_used: int
    nnz: int
    width: int
    itemsize: int

    @property
    def flops(self) -> int:
        return 2 * self.nnz * self.width


def family(name: str):
    """The count module of a model family."""
    return importlib.import_module(f"{__name__}.{name}")


def itemsize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2}[dtype]


def gemm_flops(rows: int, d_in: int, d_out: int, input_grad: bool) -> int:
    """A GEMM's operations in a training step: forward, weight gradient
    and, with ``input_grad``, input gradient."""
    one = 2 * rows * d_in * d_out
    return one * (3 if input_grad else 2)


def bytes_moved(t: Traversal) -> int:
    """A traversal's read-once bytes, by its kernel's count module."""
    return importlib.import_module(f"{__name__}.{t.kind}").bytes_moved(t)


def bound_s(t: Traversal, peaks: dict) -> float:
    """The least time the device could take for ``t``: its read-once bytes
    over the memory's rate. Its operations (2 E D) at the card's rate for
    bf16 operands take less in every cell (under 90 a byte, against the
    card's 295 at 989 TFLOP/s and 3.35 TB/s), and no implementation's own
    rate, such as its CUDA cores' in fp32, is a bound of the work."""
    return bytes_moved(t) / peaks["hbm_bytes_per_s"]
