"""The model zoo and the safe arch-string parser.

Counterpart of ``lp_gnn_tpu/models/gcn.py`` (reference arch.py:108-289):
GCN_FC, the flagship (``make_gcn_fc`` :48), GCN (:99), GCNRand (:128),
and the DeepGCN res+ stacks GCNDeeper and GENDeeper (``_make_deeper``
:148-218); ``build_model`` :230. Each model takes the options its JAX
factory takes, and no other.

Forward contract: ``model(g, generator=None)`` with ``g`` a
:class:`~lp_gnn_tpu_torch.data.graph.GraphTensors` ->
(cons_logits (m, 3), vars_logits (n, 3)), fp32, after the knowledge mask.
Every conv runs through ``g.apply_conv``, so the same forward runs over a
partition's ``parallel/edge_partition.py DistGraphTensors`` (the stacked
shards' logits), which applies each conv over the shards; the models
import nothing of ``parallel/``.
Dropout (and GCNRand's logits) draw from ``generator`` and dropout runs
only in training mode. Each model class says what its graphs need:
``reads_input_agg`` (its input conv uses the cached aggregations of
``ops/spmm.py attach_input_agg``; GEN's depends on its parameters and
cannot, trainer.py:457-459), ``needs_edge_perms`` (its backward needs
the permutations between the two edge orderings, ``from_graph(...,
perms=True)``) and ``softmax_aggregation`` (its convs aggregate by GEN's
softmax, which the edge-partitioned forward runs over the compact halo
space, ``DistGraphTensors.from_partition(..., gen=True)``).
"""
from __future__ import annotations

import ast

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .gen import BidirGENConv
from .layers import BidirGraphConv, LayerNorm, Linear, add_knowledge, dropout

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ZooModel(nn.Module):
    """What the models share: the compute dtype, remat around a conv, and
    what a graph must carry for them."""

    name = ""
    reads_input_agg = True
    needs_edge_perms = False
    softmax_aggregation = False

    def __init__(self, dtype: str = "float32", remat: bool = False):
        super().__init__()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r}: use one of {sorted(_DTYPES)}")
        self.dtype = dtype
        self.cdtype = _DTYPES[dtype]
        self.remat = remat

    def _conv(self, g, conv, left, right, input_conv: bool = False):
        """``conv`` over the graph ``g`` (``g.apply_conv``: the module's
        own conv on a graph, the conv over the shards on a partition),
        recomputed in the backward pass under remat (``torch.utils
        .checkpoint`` around the conv only, as ``jax.checkpoint`` wraps the
        conv, gcn.py:67-69 and :180-182) where ``g`` allows it: a
        partition does not, as JAX's dist forward takes no remat
        (edge_partition.py:1007-1034). Dropout stays outside the recomputed
        function, which draws no random number: the recompute need not
        restore a generator's state (and under CUDA graph capture the
        default generator's state cannot be read)."""
        if self.remat and g.remat and torch.is_grad_enabled():
            return checkpoint(g.apply_conv, conv, left, right, input_conv,
                              use_reentrant=False, preserve_rng_state=False)
        return g.apply_conv(conv, left, right, input_conv)


class GCN_FC(ZooModel):
    """1 input conv, depth-2 hidden convs, per-side Linear(hids, 3) heads;
    conv1 -> relu; hidden: conv -> dropout -> relu; heads -> knowledge
    mask (gcn.py:48). ``dtype='bfloat16'`` runs the conv / linear stack in
    bf16 with fp32 parameters, fp32 SpMM accumulation and an fp32
    knowledge mask. ``remat=True`` recomputes each conv in the backward
    pass instead of keeping its activations."""

    name = "GCN_FC"

    def __init__(self, p: int = 8, q: int = 8, hids: int = 128,
                 depth: int = 3, dp: float = 0.1, dtype: str = "float32",
                 remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(dtype, remat)
        self.depth, self.hids, self.dp = depth, hids, dp
        n_hidden = max(depth - 2, 0)
        # construction order = the JAX init's key order (conv1, layers,
        # heads); the numbers differ (torch vs threefry generators)
        self.conv1 = BidirGraphConv(p, q, hids, generator)
        self.layers = nn.ModuleList(
            BidirGraphConv(hids, hids, hids, generator)
            for _ in range(n_hidden))
        self.lin_left = Linear(hids, 3, generator=generator)
        self.lin_right = Linear(hids, 3, generator=generator)

    def forward(self, g, generator: torch.Generator | None = None):
        x_left = g.c_feas.to(self.cdtype)
        x_right = g.v_feas.to(self.cdtype)
        left, right = self._conv(g, self.conv1, x_left, x_right,
                                 input_conv=True)
        left, right = F.relu(left), F.relu(right)
        for conv in self.layers:
            left, right = self._conv(g, conv, left, right)
            left = dropout(left, self.dp, generator, self.training)
            right = dropout(right, self.dp, generator, self.training)
            left, right = F.relu(left), F.relu(right)
        left = self.lin_left(left)
        right = self.lin_right(right)
        return add_knowledge(left, right, x_left, x_right)


class GCN(ZooModel):
    """3 fixed convs (gcn.py:99-124): conv1 -> relu -> conv2 -> relu ->
    dropout 0.1 -> conv3 (width 3) -> knowledge mask."""

    name = "GCN"

    def __init__(self, p: int = 8, q: int = 8, hids: int = 128,
                 dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__(dtype)
        self.hids, self.dp = hids, 0.1
        self.conv1 = BidirGraphConv(p, q, hids, generator)
        self.conv2 = BidirGraphConv(hids, hids, hids, generator)
        self.conv3 = BidirGraphConv(hids, hids, 3, generator)

    def forward(self, g, generator: torch.Generator | None = None):
        x_left = g.c_feas.to(self.cdtype)
        x_right = g.v_feas.to(self.cdtype)
        left, right = self._conv(g, self.conv1, x_left, x_right,
                                 input_conv=True)
        left, right = F.relu(left), F.relu(right)
        left, right = self._conv(g, self.conv2, left, right)
        left, right = F.relu(left), F.relu(right)
        left = dropout(left, self.dp, generator, self.training)
        right = dropout(right, self.dp, generator, self.training)
        left, right = self._conv(g, self.conv3, left, right)
        return add_knowledge(left, right, x_left, x_right)


class GCNRand(ZooModel):
    """Random-logit control baseline (gcn.py:128-145): U[0, 1) logits
    through the knowledge mask, drawn from ``generator`` on the graph's
    device, or from one seeded 0 when none is given (the JAX apply's
    ``PRNGKey(0)`` default). Its one parameter ``_`` (0, the JAX tree's)
    gives the model a device; ``dtype`` is accepted for ``--fp16`` and has
    no effect."""

    name = "GCNRand"
    reads_input_agg = False

    def __init__(self, dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__(dtype)
        self.register_parameter("_", nn.Parameter(torch.zeros(())))

    def forward(self, g, generator: torch.Generator | None = None):
        if generator is None:
            generator = torch.Generator(device=g.device).manual_seed(0)
        left = torch.rand((g.ncons, 3), generator=generator, device=g.device)
        right = torch.rand((g.nvars, 3), generator=generator, device=g.device)
        return add_knowledge(left, right, g.c_feas, g.v_feas)


class DeepBlock(nn.Module):
    """A res+ block's parameters (gcn.py:149-152): ``conv``, ``norm_l``,
    ``norm_r``."""

    def __init__(self, hids: int, conv_cls, generator):
        super().__init__()
        self.conv = conv_cls(hids, hids, hids, generator)
        self.norm_l = LayerNorm(hids)
        self.norm_r = LayerNorm(hids)


class _Deeper(ZooModel):
    """DeepGCN res+ stack (``_make_deeper`` gcn.py:167-204): ``conv_in``
    (p, q -> hids), depth-2 blocks of norm -> relu -> dropout 0.1 -> conv
    -> + residual, ``conv_out`` (hids -> 3), the knowledge mask."""

    conv_cls = BidirGraphConv

    def __init__(self, p: int = 8, q: int = 8, hids: int = 128,
                 depth: int = 5, dtype: str = "float32", remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(dtype, remat)
        self.depth, self.hids, self.dp = depth, hids, 0.1
        self.conv_in = self.conv_cls(p, q, hids, generator)
        self.blocks = nn.ModuleList(
            DeepBlock(hids, self.conv_cls, generator)
            for _ in range(max(depth - 2, 0)))
        self.conv_out = self.conv_cls(hids, hids, 3, generator)

    def forward(self, g, generator: torch.Generator | None = None):
        x_left = g.c_feas.to(self.cdtype)
        x_right = g.v_feas.to(self.cdtype)
        left, right = self._conv(g, self.conv_in, x_left, x_right,
                                 input_conv=self.reads_input_agg)
        for blk in self.blocks:
            h_l = F.relu(blk.norm_l(left))
            h_r = F.relu(blk.norm_r(right))
            h_l = dropout(h_l, self.dp, generator, self.training)
            h_r = dropout(h_r, self.dp, generator, self.training)
            h_l, h_r = self._conv(g, blk.conv, h_l, h_r)
            left, right = left + h_l, right + h_r
        left, right = self._conv(g, self.conv_out, left, right)
        return add_knowledge(left, right, x_left, x_right)


class GCNDeeper(_Deeper):
    """The res+ stack over GraphConv (gcn.py:207)."""

    name = "GCNDeeper"

    def __init__(self, p: int = 8, q: int = 8, hids: int = 128,
                 depth: int = 50, dtype: str = "float32", remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__(p, q, hids, depth, dtype, remat, generator)


class GENDeeper(_Deeper):
    """The res+ stack over GENConv (gcn.py:215): its aggregation depends
    on its parameters, so the input conv reads no cache, and its backward
    needs the edge permutations."""

    name = "GENDeeper"
    conv_cls = BidirGENConv
    reads_input_agg = False
    needs_edge_perms = True
    softmax_aggregation = True


MODEL_REGISTRY = {"GCN_FC": GCN_FC, "GCN": GCN, "GCNRand": GCNRand,
                  "GCNDeeper": GCNDeeper, "GENDeeper": GENDeeper}


def build_model(arch: str, generator: torch.Generator | None = None) -> nn.Module:
    """Parse an arch string like ``GCN_FC(8,8,hids=1024,depth=3)`` safely
    (literal arguments only, never ``eval``); ``generator`` draws the
    initial weights."""
    tree = ast.parse(arch.strip(), mode="eval").body
    if not (isinstance(tree, ast.Call) and isinstance(tree.func, ast.Name)):
        raise ValueError(f"arch must look like Name(args...), got {arch!r}")
    name = tree.func.id
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown arch {name!r}")
    args = [ast.literal_eval(a) for a in tree.args]
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in tree.keywords}
    return MODEL_REGISTRY[name](*args, generator=generator, **kwargs)
