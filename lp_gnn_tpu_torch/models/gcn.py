"""GCN_FC, the flagship model, and the safe arch-string parser.

Counterpart of ``lp_gnn_tpu/models/gcn.py`` (``make_gcn_fc`` :48,
``build_model`` :230; reference arch.py:167-193). The rest of the JAX zoo
(GCN, GCNRand, GCNDeeper, GENDeeper) is not ported yet: asking for it
raises and names the ROADMAP item.

Forward contract: ``model(g, generator=None)`` with ``g`` a
:class:`~lp_gnn_tpu_torch.data.graph.GraphTensors` ->
(cons_logits (m, 3), vars_logits (n, 3)), fp32, after the knowledge mask.
Dropout draws from ``generator`` and runs only in training mode.
"""
from __future__ import annotations

import ast

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (BidirGraphConv, Linear, add_knowledge,
                     bidir_conv_apply_input, dropout)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GCN_FC(nn.Module):
    """1 input conv, depth-2 hidden convs, per-side Linear(hids, 3) heads;
    conv1 -> relu; hidden: conv -> dropout -> relu; heads -> knowledge
    mask. ``dtype='bfloat16'`` runs the conv / linear stack in bf16 with
    fp32 parameters, fp32 SpMM accumulation and an fp32 knowledge mask.

    ``remat=True`` recomputes each conv in the backward pass instead of
    keeping its activations (``torch.utils.checkpoint`` around each conv
    only, as ``jax.checkpoint`` wraps the conv, gcn.py:67-69). The dropout
    stays outside the recomputed function: the recompute restores the
    default generators' state, not that of an explicit one."""

    name = "GCN_FC"

    def __init__(self, p: int = 8, q: int = 8, hids: int = 128,
                 depth: int = 3, dp: float = 0.1, dtype: str = "float32",
                 remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r}: use one of {sorted(_DTYPES)}")
        self.depth, self.hids, self.dp = depth, hids, dp
        self.remat = remat
        self.dtype = dtype
        self.cdtype = _DTYPES[dtype]
        n_hidden = max(depth - 2, 0)
        # construction order = the JAX init's key order (conv1, layers,
        # heads); the numbers differ (torch vs threefry generators)
        self.conv1 = BidirGraphConv(p, q, hids, generator)
        self.layers = nn.ModuleList(
            BidirGraphConv(hids, hids, hids, generator)
            for _ in range(n_hidden))
        self.lin_left = Linear(hids, 3, generator=generator)
        self.lin_right = Linear(hids, 3, generator=generator)

    def _conv(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, g, generator: torch.Generator | None = None):
        x_left = g.c_feas.to(self.cdtype)
        x_right = g.v_feas.to(self.cdtype)
        left, right = self._conv(bidir_conv_apply_input, self.conv1, g,
                                 x_left, x_right)
        left, right = F.relu(left), F.relu(right)
        for conv in self.layers:
            left, right = self._conv(conv, g, left, right)
            left = dropout(left, self.dp, generator, self.training)
            right = dropout(right, self.dp, generator, self.training)
            left, right = F.relu(left), F.relu(right)
        left = self.lin_left(left)
        right = self.lin_right(right)
        return add_knowledge(left, right, x_left, x_right)


MODEL_REGISTRY = {"GCN_FC": GCN_FC}
# archs of the JAX zoo that wait for ROADMAP.md's queue item "GEN and the
# rest of the zoo"
_NOT_YET = ("GCN", "GCNRand", "GCNDeeper", "GENDeeper")


def build_model(arch: str, generator: torch.Generator | None = None) -> nn.Module:
    """Parse an arch string like ``GCN_FC(8,8,hids=1024,depth=3)`` safely
    (literal arguments only, never ``eval``)."""
    tree = ast.parse(arch.strip(), mode="eval").body
    if not (isinstance(tree, ast.Call) and isinstance(tree.func, ast.Name)):
        raise ValueError(f"arch must look like Name(args...), got {arch!r}")
    name = tree.func.id
    if name in _NOT_YET:
        raise NotImplementedError(
            f"{name} is not ported to lp_gnn_tpu_torch yet (ROADMAP.md, queue "
            f"item 4: GEN and the rest of the zoo); only GCN_FC is")
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown arch {name!r}")
    args = [ast.literal_eval(a) for a in tree.args]
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in tree.keywords}
    return MODEL_REGISTRY[name](*args, generator=generator, **kwargs)
