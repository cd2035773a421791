"""The one generator of training traffic: LP graphs and the order of the
steps over them, from a traffic file's parameters and ``--seed``. The
file's ``structure`` picks how an LP is made:

``uniform``, a synthetic graph of a given size drawn as
``lp_gnn_tpu_torch/bench.py make_graph`` draws the bench-shape graph (a
frozen copy of its distributions): ``nnz`` edges,
``hot_share`` of them on the first ``hot_rows`` constraints and the rest
on uniform rows, uniform columns, values in [-0.5, 0.5), features in
[-0.5, 0.5) with the bound-tag columns (-3 and -1) in {-1, 0, 1}, labels
in {0, 1, 2}. Two changes keep every seed's work alike and the draws
fast: the hot edges are exactly ``round(hot_share * nnz)`` (the first
ones drawn), and the streams are numpy's ``Generator`` in float32 and
int32, seeded per LP from ``--seed``.

``mirp``, an LP of the repo's mirp family as ``prep`` makes its training
graphs (``mirp.py``): the family's structure from ``structure_seed``,
each LP's data from ``--seed``, scaled and featured as the pipeline does.

The steps go through the LPs in an order drawn anew for each pass, as the
trainer's ``rng_np.permutation(n_train)`` does each epoch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import mirp
from .seeds import numpy_rng, sequence

FEATURES = 8   # columns of an LP's constraint and variable features


@dataclasses.dataclass
class LP:
    """One LP graph on the host: the edges in the order drawn."""
    row: np.ndarray      # (nnz,) int32 constraint of each edge
    col: np.ndarray      # (nnz,) int32 variable of each edge
    val: np.ndarray      # (nnz,) float32
    c_feas: np.ndarray   # (cons, 8) float32
    v_feas: np.ndarray   # (vars, 8) float32
    y_s: np.ndarray      # (cons,) int32 labels
    y_t: np.ndarray      # (vars,) int32 labels

    @property
    def ncons(self) -> int:
        return self.c_feas.shape[0]

    @property
    def nvars(self) -> int:
        return self.v_feas.shape[0]

    @property
    def nnz(self) -> int:
        return self.val.shape[0]


def draw_lp(traffic: dict, seed: int, index: int) -> LP:
    """The ``index``-th LP of a run with ``traffic``'s parameters."""
    return STRUCTURES[traffic["structure"]](traffic, seed, index)


def uniform_lp(traffic: dict, seed: int, index: int) -> LP:
    """A synthetic LP of ``traffic``'s sizes (module docstring)."""
    m, n, e = int(traffic["cons"]), int(traffic["vars"]), int(traffic["nnz"])
    rng = numpy_rng(seed, "lp", index)
    n_hot = int(round(float(traffic["hot_share"]) * e))
    row = np.empty(e, np.int32)
    row[:n_hot] = rng.integers(0, int(traffic["hot_rows"]), n_hot,
                               dtype=np.int32)
    row[n_hot:] = rng.integers(0, m, e - n_hot, dtype=np.int32)
    col = rng.integers(0, n, e, dtype=np.int32)
    val = rng.random(e, dtype=np.float32) - np.float32(0.5)
    feas = []
    for k in (m, n):
        fe = rng.random((k, FEATURES), dtype=np.float32) - np.float32(0.5)
        fe[:, -3] = rng.integers(-1, 2, k)
        fe[:, -1] = rng.integers(-1, 2, k)
        feas.append(fe)
    return LP(row=row, col=col, val=val, c_feas=feas[0], v_feas=feas[1],
              y_s=rng.integers(0, 3, m, dtype=np.int32),
              y_t=rng.integers(0, 3, n, dtype=np.int32))


def mirp_lp(traffic: dict, seed: int, index: int) -> LP:
    """An LP of the mirp family at ``traffic``'s sizes: the structure the
    family's ``structure_seed`` draws, the data (rates, costs) from
    ``--seed``; labels drawn uniformly among the statuses each bound
    allows (0 at the lower bound, 1 basic, 2 at the upper): no solve is
    run, and the labels set the loss's targets, not the work."""
    structure = np.random.RandomState(int(traffic["structure_seed"]))
    data = np.random.RandomState(sequence(seed, "lp", index).generate_state(4))
    c, b_l, a, b_u, lb, ub = mirp.generate(
        structure, data, int(traffic["n_ports"]), int(traffic["n_periods"]),
        float(traffic["arc_density"]), float(traffic["tightness"]))
    a, v_feas, c_feas = mirp.prepare(c, b_l, a, b_u, lb, ub)
    rng = numpy_rng(seed, "labels", index)
    return LP(row=a.row.astype(np.int32), col=a.col.astype(np.int32),
              val=a.data.astype(np.float32), c_feas=c_feas, v_feas=v_feas,
              y_s=_labels(rng, c_feas), y_t=_labels(rng, v_feas))


def _labels(rng: np.random.Generator, feas: np.ndarray) -> np.ndarray:
    """A status a node, uniform among those its bounds allow: not 0 where
    the lower bound is infinite (feature -3 nonzero), not 2 where the
    upper is (feature -1)."""
    allowed = np.stack([feas[:, -3] == 0, np.ones(len(feas), bool),
                        feas[:, -1] == 0], axis=1)
    pick = rng.random(len(feas)) * allowed.sum(1)
    return (np.cumsum(allowed, 1) <= pick[:, None]).sum(1).astype(np.int32)


STRUCTURES = {"uniform": uniform_lp, "mirp": mirp_lp}


def draw_lps(traffic: dict, seed: int) -> list[LP]:
    """Every LP of a run."""
    return [draw_lp(traffic, seed, i) for i in range(int(traffic["graphs"]))]


class StepOrder:
    """The LP of each step: pass after pass over the LPs, each pass in an
    order drawn from ``--seed``."""

    def __init__(self, n_graphs: int, seed: int):
        self.n = n_graphs
        self.rng = numpy_rng(seed, "order")
        self.pending: list[int] = []

    def next(self) -> int:
        if not self.pending:
            self.pending = [int(i) for i in self.rng.permutation(self.n)]
        return self.pending.pop(0)
