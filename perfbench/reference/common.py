"""What the plain references share: an LP's tensors, the aggregation by
``index_add_`` in blocks of edges, a Linear, the knowledge mask, dropout
with the masks it is fed, the balanced cross-entropy, Adam, and the loop
of training steps that gives a :class:`~perfbench.check.Record`.

Plain PyTorch in float32 with TF32 off. Nothing here imports the
program. A precision (``rnd``) rounds each tensor where a model computed
in a lower type would hold it in that type: the inputs and outputs of
each GEMM and aggregation, and the activations between them (where the
bf16 program holds bf16). :func:`exact` is float32 as it is (the
reference); :func:`fp8` is float8, e4m3 forward and e5m2 gradients with a
scale a tensor (the control).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..check import Record

AGG_BLOCK_BYTES = 1 << 30   # the gathered messages of one block of edges


def exact_fp32() -> None:
    """float32 GEMMs without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact(x: torch.Tensor) -> torch.Tensor:
    """The reference's precision: float32 as it is."""
    return x


def _to_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's precision: x through float8 e4m3 with one scale a
    tensor, its gradient through e5m2."""
    return _Fp8.apply(x)


@dataclasses.dataclass
class Graph:
    """An LP's tensors on the reference's device: the edges as drawn."""
    row: torch.Tensor     # (E,) int64
    col: torch.Tensor     # (E,) int64
    val: torch.Tensor     # (E,) float32
    c_feas: torch.Tensor  # (m, 8) float32
    v_feas: torch.Tensor  # (n, 8) float32
    y_s: torch.Tensor     # (m,) int64
    y_t: torch.Tensor     # (n,) int64

    @classmethod
    def of(cls, lp, device) -> "Graph":
        def t(a, dtype):
            return torch.as_tensor(a).to(device=device, dtype=dtype)
        return cls(t(lp.row, torch.int64), t(lp.col, torch.int64),
                   t(lp.val, torch.float32), t(lp.c_feas, torch.float32),
                   t(lp.v_feas, torch.float32), t(lp.y_s, torch.int64),
                   t(lp.y_t, torch.int64))

    @property
    def ncons(self) -> int:
        return self.c_feas.shape[0]

    @property
    def nvars(self) -> int:
        return self.v_feas.shape[0]


def _segment_sum(x, dst, src, val, n_dst):
    out = torch.zeros(n_dst, x.shape[1], dtype=x.dtype, device=x.device)
    block = max(1, AGG_BLOCK_BYTES // max(x.shape[1] * x.element_size(), 1))
    for s in range(0, src.shape[0], block):
        msg = x.index_select(0, src[s:s + block]).mul_(val[s:s + block, None])
        out.index_add_(0, dst[s:s + block], msg)
    return out


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, src, val, n_dst):
        ctx.save_for_backward(dst, src, val)
        ctx.n_src = x.shape[0]
        return _segment_sum(x, dst, src, val, n_dst)

    @staticmethod
    def backward(ctx, g):
        dst, src, val = ctx.saved_tensors
        return (_segment_sum(g.contiguous(), src, dst, val, ctx.n_src),
                None, None, None, None)


def aggregate(x, dst, src, val, n_dst: int) -> torch.Tensor:
    """``out[d] = sum over edges e with dst[e] = d of val[e] x[src[e]]``,
    by ``index_add_`` in blocks of edges; its gradient the same over the
    reversed edges."""
    return _Aggregate.apply(x, dst, src, val, n_dst)


def linear(P: dict, name: str, x: torch.Tensor, rnd=exact) -> torch.Tensor:
    """``x W^T + b`` of the Linear ``name`` (its bias where P has one), in
    ``rnd``'s precision."""
    y = rnd(x) @ rnd(P[f"{name}.weight"]).t()
    b = P.get(f"{name}.bias")
    return rnd(y if b is None else y + rnd(b))


def linear_spec(name: str, d_in: int, d_out: int, bias: bool = True):
    """A Linear's parameters as ``torch.nn.Linear`` draws them."""
    bound = 1.0 / math.sqrt(d_in)
    spec = [(f"{name}.weight", (d_out, d_in), ("uniform", bound))]
    if bias:
        spec.append((f"{name}.bias", (d_out,), ("uniform", bound)))
    return spec


def layer_norm(P: dict, name: str, x: torch.Tensor, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * P[f"{name}.weight"] + \
        P[f"{name}.bias"]


def knowledge(logit: torch.Tensor, feas: torch.Tensor, bound: float = 10.0):
    """Each row scaled to norm 10, then ``bound`` off the LL logit where
    the lower bound is infinite (feature -3 nonzero) and off the UL logit
    where the upper is (feature -1)."""
    norm = torch.sqrt((logit * logit).sum(-1, keepdim=True))
    x = logit / norm.clamp(min=1e-12) * 10.0
    off = torch.zeros_like(x)
    off[:, 0] = torch.where(feas[:, -3] != 0, -bound, 0.0)
    off[:, 2] = torch.where(feas[:, -1] != 0, -bound, 0.0)
    return x + off


class MaskMismatch(ValueError):
    """The masks fed do not fit the dropout the reference's forward
    applies: fewer, more, or of other shapes."""


class Dropout:
    """Inverted dropout at ``rate``, its masks (True: kept) taken from
    ``masks`` (:class:`FedMasks` or :class:`DrawnMasks`) in the order the
    forward applies dropout."""

    def __init__(self, rate: float, masks):
        self.rate, self.masks = rate, masks

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0:
            return x
        keep = 1.0 - self.rate
        return torch.where(self.masks.take(x.shape, x.device), x / keep, 0.0)


class FedMasks:
    """The masks another side applied, in the order it applied them: the
    reference applies the same ones, however they were drawn."""

    def __init__(self, masks: list[torch.Tensor]):
        self.masks, self.at = list(masks), 0

    def take(self, shape, device) -> torch.Tensor:
        if self.at >= len(self.masks):
            raise MaskMismatch(f"{len(self.masks)} dropout masks fed, the "
                               f"forward applies more")
        mask = self.masks[self.at]
        self.at += 1
        if tuple(mask.shape) != tuple(shape):
            raise MaskMismatch(f"dropout mask {self.at - 1} fed of shape "
                               f"{tuple(mask.shape)}, applied to "
                               f"{tuple(shape)}")
        return mask.to(device)

    def done(self) -> None:
        if self.at != len(self.masks):
            raise MaskMismatch(f"{len(self.masks)} dropout masks fed, the "
                               f"forward applied {self.at}")


class DrawnMasks:
    """Masks drawn as ``U < 1 - rate``, U from ``torch.rand(shape,
    generator)``, and kept on the host (``kept``) to feed another side."""

    def __init__(self, rate: float, generator: torch.Generator):
        self.keep, self.gen, self.kept = 1.0 - rate, generator, []

    def take(self, shape, device) -> torch.Tensor:
        mask = torch.rand(shape, generator=self.gen, device=device) < self.keep
        self.kept.append(mask.cpu())
        return mask

    def done(self) -> None:
        pass


def _class_weights(y: torch.Tensor) -> torch.Tensor:
    cnt = torch.bincount(y, minlength=3).double()
    wei = torch.where(cnt > 0, cnt.sum() / cnt.clamp(min=1.0), 0.0)
    if int((cnt > 0).sum()) != 2:   # one-sided LPs keep their weights
        lu = (wei[0] + wei[2]) / 2
        wei = torch.stack([lu, wei[1], lu])
    return wei.float()


def _weighted_ce(logits, y, w):
    ce = torch.logsumexp(logits, -1) - logits.gather(-1, y[:, None])[:, 0]
    wy = w[y]
    return (wy * ce).sum() / wy.sum().clamp(min=1e-12)


def balanced_ce(lc, lv, y_s, y_t) -> torch.Tensor:
    """Each side's class-weighted cross-entropy (weight total / count a
    class, LL and UL averaged where all three occur), scaled by (m + n) / m
    and (m + n) / n."""
    m, n = y_s.shape[0], y_t.shape[0]
    return ((m + n) / m * _weighted_ce(lc, y_s, _class_weights(y_s))
            + (m + n) / n * _weighted_ce(lv, y_t, _class_weights(y_t)))


class Adam:
    """Adam with coupled weight decay (``g + wd p`` is the gradient the
    moments see), bias-corrected, on a dict of leaves."""

    def __init__(self, P: dict, lr: float, betas, eps: float, wd: float):
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, wd
        self.m = {k: torch.zeros_like(v) for k, v in P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in P.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, P: dict, grads: dict) -> dict:
        """The update; returns the gradients as the moments saw them."""
        self.t += 1
        seen = {}
        for k, p in P.items():
            g = grads[k] + self.wd * p
            seen[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = self.m[k] / (1 - self.b1 ** self.t)
            vh = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return seen


def train_steps(family, cfg: dict, weights: dict, graphs: list, order: list,
                masks, rnd=exact, loss=balanced_ce) -> Record:
    """``len(order)`` steps of ``family``'s model from ``weights`` (not
    changed), step i on ``graphs[order[i]]`` (LPs on the host, each moved
    to the weights' device at its first use), dropout's masks from
    ``masks`` (:class:`FedMasks` or :class:`DrawnMasks`): the reference's
    :class:`~perfbench.check.Record`. Raises :class:`MaskMismatch` where
    masks fed do not fit the forward's dropout."""
    dev = next(iter(weights.values())).device
    P = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in weights.items()}
    opt = Adam(P, cfg["lr"], cfg["betas"], cfg["eps"], cfg["weight_decay"])
    drop = Dropout(cfg["dropout"], masks)
    on_dev: dict[int, Graph] = {}
    losses, grad1, grad1_vec = [], {}, {}
    for i in order:
        if i not in on_dev:
            on_dev[i] = Graph.of(graphs[i], dev)
        g = on_dev[i]
        lc, lv = family.forward(P, g, cfg, drop, rnd)
        value = loss(lc, lv, g.y_s, g.y_t)
        grads = torch.autograd.grad(value, list(P.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if gr is None else gr
                 for (k, p), gr in zip(P.items(), grads)}
        del lc, lv
        seen = opt.step(P, grads)
        losses.append(float(value.detach()))
        if len(losses) == 1:
            grad1 = {k: float(v.norm()) for k, v in seen.items()}
            grad1_vec = {k: v.detach().float().cpu() for k, v in seen.items()}
        del value, grads, seen
    masks.done()
    change = {k: float((P[k].detach() - weights[k].float()).norm())
              for k in P}
    return Record(losses=losses, grad1=grad1, change=change,
                  grad1_vec=grad1_vec)
