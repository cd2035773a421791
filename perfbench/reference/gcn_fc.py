"""GCN_FC in plain PyTorch (reference ``arch.py`` GCN_FC, the paper's
mirp recipe): an input two-direction GraphConv (p, q -> hids), depth - 2
hidden ones (hids -> hids), each followed by dropout and relu, the
per-side ``Linear(hids, 3)`` heads and the knowledge mask.

A two-direction GraphConv (PyG ``GraphConv(aggr='add')`` each way)::

    right' = left2right.lin_rel(A^T left) + left2right.lin_root(right)
    left'  = right2left.lin_rel(A right)  + right2left.lin_root(left)

with A the LP's constraint matrix (constraints the rows), ``lin_rel``
with a bias and ``lin_root`` without. The input conv's aggregations of
the raw features are computed as any other (the program caches them once
a graph; they are constants of the graph either way).
"""
from __future__ import annotations

import torch

from .common import aggregate, exact, knowledge, linear, linear_spec


def param_spec(cfg: dict) -> list[tuple]:
    """The parameters, named as the program's ``state_dict`` names them."""
    p, q, h, depth = cfg["p"], cfg["q"], cfg["hids"], cfg["depth"]
    spec = []

    def conv(name, left_dim, right_dim, out):
        spec.extend(linear_spec(f"{name}.left2right.lin_rel", left_dim, out))
        spec.extend(linear_spec(f"{name}.left2right.lin_root", right_dim, out,
                                bias=False))
        spec.extend(linear_spec(f"{name}.right2left.lin_rel", right_dim, out))
        spec.extend(linear_spec(f"{name}.right2left.lin_root", left_dim, out,
                                bias=False))

    conv("conv1", p, q, h)
    for i in range(max(depth - 2, 0)):
        conv(f"layers.{i}", h, h, h)
    spec.extend(linear_spec("lin_left", h, 3))
    spec.extend(linear_spec("lin_right", h, 3))
    return spec


def _conv(P, name, g, left, right, rnd):
    agg_c = rnd(aggregate(rnd(right), g.row, g.col, g.val, g.ncons))  # A right
    agg_v = rnd(aggregate(rnd(left), g.col, g.row, g.val, g.nvars))   # A^T left
    new_right = rnd(linear(P, f"{name}.left2right.lin_rel", agg_v, rnd)
                    + linear(P, f"{name}.left2right.lin_root", right, rnd))
    new_left = rnd(linear(P, f"{name}.right2left.lin_rel", agg_c, rnd)
                   + linear(P, f"{name}.right2left.lin_root", left, rnd))
    return new_left, new_right


def forward(P: dict, g, cfg: dict, drop, rnd=exact):
    """(constraint logits (m, 3), variable logits (n, 3)) after the
    knowledge mask; ``drop`` is dropout (left, then right, a hidden
    conv)."""
    left, right = _conv(P, "conv1", g, rnd(g.c_feas), rnd(g.v_feas), rnd)
    left, right = torch.relu(left), torch.relu(right)
    for i in range(max(cfg["depth"] - 2, 0)):
        left, right = _conv(P, f"layers.{i}", g, left, right, rnd)
        left, right = rnd(drop(left)), rnd(drop(right))
        left, right = torch.relu(left), torch.relu(right)
    return (knowledge(linear(P, "lin_left", left, rnd), g.c_feas),
            knowledge(linear(P, "lin_right", right, rnd), g.v_feas))
