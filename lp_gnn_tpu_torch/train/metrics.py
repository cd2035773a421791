"""Classification metrics (counterpart of ``lp_gnn_tpu/train/metrics.py``;
reference val.py:199-237).

accuracy = mean of the per-side accuracies after the top-m decode;
precision / recall are for class 1 (basic), averaged over the two sides.
``stoch`` datasets score the variable side only (their constraints are
always nonbasic).
"""
from __future__ import annotations

import logging

import numpy as np

from ..infer.decode import inference_gnn


def _prec_recall_class1(gt: np.ndarray, pred: np.ndarray):
    tp = ((pred == 1) & (gt == 1)).sum()
    fp = ((pred == 1) & (gt != 1)).sum()
    fn = ((pred != 1) & (gt == 1)).sum()
    prec = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recl = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    return float(prec), float(recl)


def accuracy(logits, gt, num_cons: int, return_pr: bool = False,
             dataset_name: str = ""):
    """Decode then score (metrics.py:25). ``logits`` (m+n, 3) constraints
    first; ``gt`` (m+n,) int labels."""
    logits = np.asarray(logits)
    gt = np.asarray(gt)
    pred = inference_gnn(logits, num_cons)
    uniq = np.unique(pred[:num_cons])
    if uniq.shape[0] == 1 and uniq[0] == 1:
        logging.warning("may collapse: predicted basis == all slacks")
    stoch = bool(dataset_name) and "stoch" in dataset_name
    acc1 = float((gt[:num_cons] == pred[:num_cons]).mean())
    acc2 = float((gt[num_cons:] == pred[num_cons:]).mean())
    if stoch:
        acc1 = acc2
    acc = (acc1 + acc2) / 2.0
    if not return_pr:
        return acc
    p1, r1 = _prec_recall_class1(gt[:num_cons], pred[:num_cons])
    p2, r2 = _prec_recall_class1(gt[num_cons:], pred[num_cons:])
    if stoch:
        p1, r1 = p2, r2
    return acc, (p1 + p2) / 2.0, (r1 + r2) / 2.0
