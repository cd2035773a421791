"""Model building blocks: linear, layer norm, two-direction graph conv,
knowledge mask, dropout.

Counterpart of ``lp_gnn_tpu/models/layers.py`` (reference arch.py:51-141),
as ``nn.Module``s named after the reference's state_dict keys
(``left2right.lin_rel.weight`` ...), so a reference ``mdl.pth`` loads as it
is. Parameters stay fp32; compute runs in the dtype of the inputs, and the
knowledge mask always in fp32. A bf16 GEMM on the card sums its products
in fp32 and rounds once, as the TPU's matrix unit does for the reference
and as the port's SpMM does: importing this module turns off cuBLAS's
reduced-precision reduction of bf16 split-K partials
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``),
which otherwise rounds each partial to bf16.

cuBLAS picks its kernel, and how it splits a GEMM's sum, by the GEMM's
rows, and a narrow GEMM (the 3-wide heads) rounds differently at
different row counts: on an H100 a mirp_bench LP's bf16 logits on a
rank's shard of 512 constraint rows and on the same rows among 4 stacked
shards fell further apart than 2^-6 (``chip_smoke.py --layout_gemms``,
PERF.md), and its decoded bases differed. So while the stacked shards'
forward runs (:func:`shard_rows`, set by
``parallel/edge_partition.py module_forward``), a Linear of at most
NARROW outputs runs one GEMM a shard's rows, as a rank and JAX's
``shard_map`` run it, and the layouts agree bit for bit; a wide one runs
one GEMM over all rows (cuBLAS gave the same bits there at every row
count measured, and a concatenation of wide outputs would cost a copy).
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spmm import spmm_cons_to_vars, spmm_vars_to_cons

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

NARROW = 8   # outputs of a Linear that runs one GEMM a shard (shard_rows)
_SHARDS = threading.local()


@contextlib.contextmanager
def shard_rows(k: int):
    """Within it, in this thread, the rows of a Linear's input are k equal
    blocks, one a stacked edge shard: a narrow Linear runs one GEMM a
    block, whose rows a rank holding that shard would hold."""
    prev = getattr(_SHARDS, "k", 1)
    _SHARDS.k = k
    try:
        yield
    finally:
        _SHARDS.k = prev


class Linear(nn.Module):
    """``y = x W^T + b`` with torch.nn.Linear's init, U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) for weight and bias, drawn from an explicit
    ``generator`` (layers.py:18-34). Weights are cast to x's dtype."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in).uniform_(-bound, bound, generator=generator))
        self.bias = nn.Parameter(
            torch.empty(d_out).uniform_(-bound, bound, generator=generator)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        w = self.weight.to(x.dtype)
        k = getattr(_SHARDS, "k", 1)
        if k > 1 and w.shape[0] <= NARROW and x.dim() == 2 and \
                x.shape[0] % k == 0:
            return torch.cat([F.linear(c, w, b) for c in x.chunk(k)])
        return F.linear(x, w, b)


class LayerNorm(nn.Module):
    """Layer norm over the last axis (layers.py:132-141): computed in fp32
    (fp64 for fp64 x) with the population variance and eps 1e-5, the
    affine ``weight`` (JAX ``g``, init 1) and ``bias`` (``b``, init 0),
    cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(acc), (x.shape[-1],), self.weight.to(acc),
                            self.bias.to(acc), self.eps).to(x.dtype)


class GraphConv(nn.Module):
    """One direction of PyG GraphConv(aggr=add):
    ``out_dst = lin_rel(sum_src A x_src) + lin_root(x_dst)``."""

    def __init__(self, src_dim: int, dst_dim: int, out_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lin_rel = Linear(src_dim, out_dim, bias=True, generator=generator)
        self.lin_root = Linear(dst_dim, out_dim, bias=False,
                               generator=generator)

    def forward(self, agg: torch.Tensor, x_dst: torch.Tensor) -> torch.Tensor:
        return self.lin_rel(agg) + self.lin_root(x_dst)


class BidirGraphConv(nn.Module):
    """GraphConvTwoDirection (layers.py:38-89, reference arch.py:51-81):
    ``left2right`` updates variables from constraints, ``right2left`` the
    reverse; both aggregate with the CSR SpMM."""

    def __init__(self, left_dim: int, right_dim: int, out_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.left2right = GraphConv(left_dim, right_dim, out_dim, generator)
        self.right2left = GraphConv(right_dim, left_dim, out_dim, generator)

    def forward(self, g, left: torch.Tensor, right: torch.Tensor):
        right_new = self.left2right(spmm_cons_to_vars(g, left), right)
        left_new = self.right2left(spmm_vars_to_cons(g, right), left)
        return left_new, right_new

    def apply_input(self, g, left: torch.Tensor, right: torch.Tensor):
        """This conv as the input conv (layers.py:73-89): where ``g``
        carries the cached input aggregations (``ops/spmm.py
        attach_input_agg``) in the inputs' dtype, it uses them instead of
        running the two SpMMs (exact: the raw features are constants of the
        graph); otherwise it is ``self(g, left, right)``."""
        agg_c, agg_v = g.in_agg_c, g.in_agg_v
        if agg_c is None or agg_v is None or agg_c.dtype != right.dtype or \
                agg_v.dtype != left.dtype:
            return self(g, left, right)
        return self.right2left(agg_c, left), self.left2right(agg_v, right)


def add_knowledge(left_logit, right_logit, left_feas, right_feas,
                  bound: float = 10.0):
    """Suppress infeasible statuses given +-inf bounds (layers.py:93,
    reference arch.py:129-141), always in fp32: L2-normalize each logit row
    (eps 1e-12) and scale by 10, then subtract ``bound`` from the LL logit
    where the lower bound is infinite (tag != 0 at feature column -3) and
    from the UL logit where the upper bound is infinite (column -1)."""
    def norm10(x):
        x = x.float()
        n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        return x / torch.clamp(n, min=1e-12) * 10.0

    def mask(logit, feas):
        delta = torch.zeros_like(logit)
        delta[:, 0] = torch.where(feas[:, -3].abs() > 0, -bound, 0.0)
        delta[:, 2] = torch.where(feas[:, -1].abs() > 0, -bound, 0.0)
        return logit + delta

    return (mask(norm10(left_logit), left_feas),
            mask(norm10(right_logit), right_feas))


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None, train: bool) -> torch.Tensor:
    """Inverted dropout (layers.py:124-129) drawing its mask from an
    explicit ``generator`` on x's device (the default one if None): keep
    each entry with probability 1 - rate, scale kept ones by 1 / (1 -
    rate), in x's dtype. The identity unless ``train`` and rate > 0."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
