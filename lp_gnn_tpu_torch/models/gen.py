"""The GENConv-equivalent two-direction layer (counterpart of
``lp_gnn_tpu/models/gen.py``: ``gen_dir_init`` / ``gen_dir_apply``
:109-150, ``gen_bidir_init`` / ``gen_bidir_apply`` :153-170; reference
arch.py:84-105 with its monkeypatched forward, arch.py:11-48).

Per direction, with x_src / x_dst mapped into the output width by the
optional ``lin_src`` / ``lin_dst`` where theirs differs::

    aggr = softmax aggregation of relu(x_src[src] + edge(a)) + 1e-7   (t)
    out  = l2(relu(ln(l1(aggr + x_dst))))

The aggregation is :func:`~lp_gnn_tpu_torch.ops.gen_agg.gen_softmax_agg`,
the hand-written forward and backward kernels; the dense parts (Linear,
LayerNorm) are plain torch ops. Parameters are named after the JAX tree
(``edge``, ``t``, ``mlp.{l1,ln,l2}``, ``lin_src``, ``lin_dst``) under the
port's ``left2right`` / ``right2left`` directions; the reference's PyG
``GENConv`` keys are not reproduced (no reference GEN checkpoint is at
hand to check them against).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gen_agg import gen_softmax_agg
from .layers import LayerNorm, Linear


class GENConv(nn.Module):
    """One GEN direction (gen.py:109-150): edge encoder ``edge`` (1 ->
    d_out), temperature ``t`` (init 1), MLP ``mlp.l1`` (d_out -> 2 d_out),
    ``mlp.ln``, ``mlp.l2`` (2 d_out -> d_out); ``lin_src`` / ``lin_dst``
    where d_src / d_dst differ from d_out."""

    def __init__(self, d_src: int, d_dst: int, d_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        # construction order = the JAX init's key order (edge, l1, l2,
        # lin_src, lin_dst); the numbers differ (torch vs threefry)
        self.edge = Linear(1, d_out, generator=generator)
        self.t = nn.Parameter(torch.ones(()))
        l1 = Linear(d_out, 2 * d_out, generator=generator)
        l2 = Linear(2 * d_out, d_out, generator=generator)
        self.mlp = nn.ModuleDict({"l1": l1, "ln": LayerNorm(2 * d_out),
                                  "l2": l2})
        self.lin_src = (Linear(d_src, d_out, generator=generator)
                        if d_src != d_out else None)
        self.lin_dst = (Linear(d_dst, d_out, generator=generator)
                        if d_dst != d_out else None)

    def project(self, x_src: torch.Tensor, x_dst: torch.Tensor):
        """x_src and x_dst in the output width (``lin_src`` / ``lin_dst``)."""
        if self.lin_src is not None:
            x_src = self.lin_src(x_src)
        if self.lin_dst is not None:
            x_dst = self.lin_dst(x_dst)
        return x_src, x_dst

    def encoder(self, dtype: torch.dtype):
        """The aggregation's w, b (the edge encoder) and t in ``dtype``,
        contiguous."""
        return (self.edge.weight[:, 0].to(dtype).contiguous(),
                self.edge.bias.to(dtype).contiguous(),
                self.t.to(dtype).contiguous())

    def update(self, aggr: torch.Tensor, x_dst: torch.Tensor) -> torch.Tensor:
        """``l2(relu(ln(l1(aggr + x_dst))))`` in x_dst's dtype."""
        h = aggr.to(x_dst.dtype) + x_dst
        h = F.relu(self.mlp["ln"](self.mlp["l1"](h)))
        return self.mlp["l2"](h)

    def forward(self, ptr, src, a, t_ptr, eperm, x_src: torch.Tensor,
                x_dst: torch.Tensor) -> torch.Tensor:
        """Over the edges (ptr, src, a) sorted by destination; (t_ptr,
        eperm) is the transpose ordering for x_src's gradient (None when
        none is wanted)."""
        x_src, x_dst = self.project(x_src, x_dst)
        aggr = gen_softmax_agg(ptr, src, a, x_src, *self.encoder(x_src.dtype),
                               t_ptr, eperm)
        return self.update(aggr, x_dst)


class BidirGENConv(nn.Module):
    """``left2right`` updates variables from constraints over the CSC,
    ``right2left`` constraints from variables over the CSR
    (gen.py:159-170); each direction's gather takes its backward over the
    other ordering, through the graph's edge permutations."""

    def __init__(self, left_dim: int, right_dim: int, out_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.left2right = GENConv(left_dim, right_dim, out_dim, generator)
        self.right2left = GENConv(right_dim, left_dim, out_dim, generator)

    def forward(self, g, left: torch.Tensor, right: torch.Tensor):
        right_new = self.left2right(g.colptr, g.row, g.val_c, g.rowptr,
                                    g.eperm_r, left, right)
        left_new = self.right2left(g.rowptr, g.col, g.val_r, g.colptr,
                                   g.eperm_c, right, left)
        return left_new, right_new
