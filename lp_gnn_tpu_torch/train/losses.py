"""Training losses (counterpart of ``lp_gnn_tpu/train/losses.py``:18-137;
reference train.py:18-53, utils.py:286-299).

All loss functions share the signature::

    loss_fn(logit_cons, logit_vars, y_s, y_t, mask_s, mask_t, psum=local)
        -> scalar

with int64 labels and bool masks that select the seed nodes contributing to
the loss (all-true for a full graph: the port has no padded rows). Every
reduction stays on the device: nothing here waits for the card. ``psum``
sums a tensor of this process's partial sums over the processes that hold
the rest of the graph, as the JAX dist losses' psums do
(``lp_gnn_tpu/parallel/edge_partition.py:1066-1171``): the identity for a
graph held whole, an all-reduce over an edge group's ranks
(``parallel/edge_partition.py psum_over``). Each loss stacks what it sums
at one point into one tensor, so a call makes few reductions.
"""
from __future__ import annotations

import torch


def _ce_per_node(logits, labels):
    """Cross-entropy from raw logits, fp32 (losses.py:18)."""
    logits = logits.float()
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - picked


def local(x):
    """The ``psum`` of a graph held whole: the sums as they are."""
    return x


def labels_to_balanced_weights(labels, mask, merge_lu: bool = True,
                               psum=local):
    """Per-class weights total/count over the masked labels (losses.py:26).
    With 2 classes present they stay as they are (one-sided LPs); otherwise
    the LL and UL weights are averaged (two-sided)."""
    cnt = psum(torch.stack([((labels == k) & mask).sum()
                            for k in range(3)]).float())
    wei = torch.where(cnt > 0, cnt.sum() / cnt.clamp(min=1.0), 0.0)
    if not merge_lu:
        return wei
    lu = (wei[0] + wei[2]) / 2.0
    merged = torch.stack([lu, wei[1], lu])
    return torch.where((cnt > 0).sum() != 2, merged, wei)


def _weighted_ce(logits, labels, mask, weights, node_w=None, psum=local):
    """torch CrossEntropyLoss(weight=w): sum(w_y ce) / sum(w_y), with
    ``node_w`` multiplied into w_y where given (losses.py:40)."""
    ce = _ce_per_node(logits, labels)
    w = weights[labels] * mask.float()
    if node_w is not None:
        w = w * node_w
    num, den = psum(torch.stack([(w * ce).sum(), w.sum()]))
    return num / den.clamp(min=1e-12)


def unbalanced(logit_cons, logit_vars, y_s, y_t, mask_s, mask_t, psum=local):
    """Plain mean CE over both sides (losses.py:51)."""
    ce = torch.cat([_ce_per_node(logit_cons, y_s),
                    _ce_per_node(logit_vars, y_t)])
    m = torch.cat([mask_s, mask_t]).float()
    num, den = psum(torch.stack([(ce * m).sum(), m.sum()]))
    return num / den.clamp(min=1e-12)


def _side_scales(mask_s, mask_t, psum=local):
    m, n = psum(torch.stack([mask_s.sum(), mask_t.sum()]).float())
    return (m + n) / m.clamp(min=1.0), (m + n) / n.clamp(min=1.0)


def balanced(logit_cons, logit_vars, y_s, y_t, mask_s, mask_t, psum=local):
    """Per-side class-weighted CE scaled by (m+n)/m and (m+n)/n
    (losses.py:59)."""
    sc_s, sc_t = _side_scales(mask_s, mask_t, psum)
    w_s = labels_to_balanced_weights(y_s, mask_s, psum=psum)
    w_t = labels_to_balanced_weights(y_t, mask_t, psum=psum)
    return (sc_s * _weighted_ce(logit_cons, y_s, mask_s, w_s, psum=psum)
            + sc_t * _weighted_ce(logit_vars, y_t, mask_t, w_t, psum=psum))


def focal(logit_cons, logit_vars, y_s, y_t, mask_s, mask_t,
          gamma: float = 2.0, psum=local):
    """Focal loss with the reference's quirk, reproduced: the modulation is
    applied to the *mean* CE (losses.py:71-77)."""
    ce = unbalanced(logit_cons, logit_vars, y_s, y_t, mask_s, mask_t, psum)
    return (1.0 - torch.exp(-ce)) ** gamma * ce


def _decode_threshold(pm, m_int, iters: int = 24, psum=local):
    """The m-th largest value of ``pm`` (masked entries -inf) by ``iters``
    bisection passes on [0, 1] (losses.py:80), in fp32 on the device."""
    lo = torch.zeros((), dtype=torch.float32, device=pm.device)
    hi = torch.ones((), dtype=torch.float32, device=pm.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        # threshold at or above mid
        take = psum((pm >= mid).sum()) >= m_int
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return lo


def critical(logit_cons, logit_vars, y_s, y_t, mask_s, mask_t,
             alpha: float = 4.0, tau: float = 0.05, psum=local):
    """Balanced CE with each node's weight multiplied by ``1 + alpha
    exp(-(p - theta)^2 / (2 tau^2))``, p its P(basic) and theta the top-m
    decode threshold, both without gradient (losses.py:97)."""
    lc, lv = logit_cons.float(), logit_vars.float()
    p = torch.softmax(torch.cat([lc, lv]), dim=-1)[:, 1]
    mask = torch.cat([mask_s, mask_t])
    pm = torch.where(mask, p, -torch.inf)
    theta = _decode_threshold(pm, psum(mask_s.sum()), psum=psum)
    w_crit = 1.0 + alpha * torch.exp(-(p - theta) ** 2 / (2.0 * tau * tau))
    w_crit = torch.where(torch.isfinite(w_crit), w_crit, 1.0).detach()
    sc_s, sc_t = _side_scales(mask_s, mask_t, psum)
    w_s = labels_to_balanced_weights(y_s, mask_s, psum=psum)
    w_t = labels_to_balanced_weights(y_t, mask_t, psum=psum)
    nc = lc.shape[0]
    return (sc_s * _weighted_ce(logit_cons, y_s, mask_s, w_s,
                                node_w=w_crit[:nc], psum=psum)
            + sc_t * _weighted_ce(logit_vars, y_t, mask_t, w_t,
                                  node_w=w_crit[nc:], psum=psum))


LOSS_REGISTRY = {"unbalanced": unbalanced, "balanced": balanced,
                 "focal": focal, "critical": critical}
