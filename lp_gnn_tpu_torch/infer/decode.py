"""Basis decoding: logits -> valid simplex basis statuses.

Counterpart of ``lp_gnn_tpu/infer/decode.py`` (:25-186; reference
val.py:106-197), label for label. The decode picks the top-m nodes by
P(basic) as the basis (m = #constraints) and gives everyone else argmax
over {LL, UL}. The two validity rules (val.py:119-122) hold by construction
and are checked by the host decode:

- exactly m basic nodes in total;
- #basic structural variables == #nonbasic rows.

:func:`inference_gnn` is the host decode (numpy) of the prediction passes;
:func:`decode_topm_device` the same selection on the device, for the
trainer's per-step accuracy.
"""
from __future__ import annotations

import ast

import numpy as np
import torch


def _softmax_np(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def inference_gnn(logits: np.ndarray, m: int, **_) -> np.ndarray:
    """Top-m decode (reference val.py:106-124). ``logits``: (m+n, 3) with
    constraints first. Returns int labels (m+n,)."""
    logits = np.asarray(logits, dtype=np.float64)
    n = logits.shape[0] - m
    pr = _softmax_np(logits)
    pr[np.isnan(pr)] = 0.0  # half-precision guard (val.py:111)

    # stable top-m by P(basic), ties broken by position like torch.topk
    order = np.argsort(-pr[:, 1], kind="stable")
    topk_idx = order[:m]
    pr[:, 1] = pr.min() - 1
    pr[topk_idx, 1] = pr.max() + 1
    pred = pr.argmax(-1)

    if (pred == 1).sum() != m or (pred[m:m + n] == 1).sum() != \
            ((pred[:m] == 0) | (pred[:m] == 2)).sum():
        raise RuntimeError("decoded basis breaks the validity rules")
    return pred


def inference_all_slacks(logits: np.ndarray, m: int, **_) -> np.ndarray:
    """All-slack basis control baseline (reference val.py:127-135)."""
    logits = np.asarray(logits, dtype=np.float64)
    pr = _softmax_np(logits)
    pred = np.ones(logits.shape[0], dtype=np.int64)
    pr[:, 1] = pr.min() - 1
    pred[m:] = pr[m:, :].argmax(-1)
    return pred


def inference_gnn_sparsity(logits: np.ndarray, m: int, nnzs=None,
                           mode: str = "add", gnn_wei: float = 0.5) -> np.ndarray:
    """Blend GNN P(basic) with an inverse-nnz sparsity prior
    (reference val.py:137-165)."""
    if mode not in ("add", "mult"):
        raise ValueError(f"mode {mode!r}: 'add' or 'mult'")
    logits = np.asarray(logits, dtype=np.float64)
    pr = _softmax_np(logits)
    nnzs = np.asarray(nnzs, dtype=np.float64).copy()
    nnzs[nnzs == 0] = nnzs.max() + 1   # vars absent from A should be nonbasic
    nnzs = 1.0 / nnzs
    nnzs /= nnzs.sum()
    nnzs *= m
    pr_gnn = pr[:, 1]
    if mode == "add":
        if gnn_wei is None:
            raise ValueError("mode 'add' needs gnn_wei")
        pr_basis = gnn_wei * pr_gnn + (1 - gnn_wei) * nnzs
    else:
        pr_basis = pr_gnn * nnzs
    pr[:, 1] = pr_basis
    order = np.argsort(-pr[:, 1], kind="stable")
    topk_idx = order[:m]
    pr[:, 1] = pr.min() - 1
    pr[topk_idx, 1] = pr.max() + 1
    return pr.argmax(-1)


def decode_topm_device(logit_cons, logit_vars, cons_mask, vars_mask, m):
    """Top-m decode on the device (decode.py:87): rank by descending
    P(basic) with a stable sort (torch.topk's tie order), masked rows
    excluded; the top ``m`` (a Python int or a 0-d tensor) are basic, the
    rest LL where P(LL) >= P(UL), else UL. Returns (pred_cons, pred_vars)
    int64, masked rows -1."""
    pr_c = torch.softmax(logit_cons.float(), dim=-1).nan_to_num(nan=0.0)
    pr_v = torch.softmax(logit_vars.float(), dim=-1).nan_to_num(nan=0.0)
    key = torch.cat([torch.where(cons_mask, pr_c[:, 1], -torch.inf),
                     torch.where(vars_mask, pr_v[:, 1], -torch.inf)])
    order = torch.argsort(-key, stable=True)
    # the inverse permutation (the JAX package takes a second argsort,
    # which avoids a scatter on the TPU; the result is the same)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    p0 = torch.cat([pr_c[:, 0], pr_v[:, 0]])
    p2 = torch.cat([pr_c[:, 2], pr_v[:, 2]])
    pred = torch.where(rank < m, 1, torch.where(p0 >= p2, 0, 2))
    pred = torch.where(torch.cat([cons_mask, vars_mask]), pred, -1)
    mp = logit_cons.shape[0]
    return pred[:mp], pred[mp:]


class InferenceManager:
    """Maps decode-strategy choice to functions and output folder names
    (reference val.py:167-197)."""

    FUNCS = ["inference_gnn", "inference_all_slacks", "inference_gnn_sparsity"]

    def __init__(self, which_func: int, mode=None, gnn_wei=None, run: int = 0):
        self.which_func = self.FUNCS[which_func]
        if mode is not None and isinstance(mode, int):
            mode = ["add", "mult"][mode]
        self.mode = mode
        self.gnn_wei = gnn_wei
        self.run = run

    def decode_fn(self):
        return {"inference_gnn": inference_gnn,
                "inference_all_slacks": inference_all_slacks,
                "inference_gnn_sparsity": inference_gnn_sparsity}[self.which_func]

    def decode_kwargs(self) -> dict:
        """Configured decode options to forward to :meth:`decode_fn`."""
        kw = {}
        if self.mode is not None:
            kw["mode"] = self.mode
        if self.gnn_wei is not None:
            kw["gnn_wei"] = self.gnn_wei
        return kw

    def get_log_folder(self) -> str:
        if self.which_func == "inference_gnn":
            return f"gnn-bas-{self.run}"
        return self.get_basis_folder()

    def get_basis_folder(self) -> str:
        if self.which_func == "inference_gnn":
            return "pred-basis" if self.run == 0 else f"pred-basis-{self.run}"
        if self.which_func == "inference_all_slacks":
            return f"all-slacks-bas-{self.run}"
        return f"gnn-sparsity-{self.mode}-{self.gnn_wei}-{self.run}"


#: families whose short, repair-prone solves get the sparsity-mult decode
#: under ``auto`` (the JAX package's round-3 decode study)
MULT_DECODE_FAMILIES = ("svm", "stoch")


def parse_inference_manager(spec: str,
                            dataset: str | None = None) -> InferenceManager:
    """Safe parser for CLI strings like ``InferenceManager(0, run=0)``
    (replaces reference ``eval(args.inference_manager)``, pred_basis.py:124).
    ``"auto"`` picks sparsity-mult for ``MULT_DECODE_FAMILIES`` and top-m
    otherwise (needs ``dataset``)."""
    if spec.strip() == "auto":
        if not dataset:
            raise ValueError("'auto' inference manager needs the dataset name")
        fam = dataset.split("-")[0].split("_")[0]
        if fam in MULT_DECODE_FAMILIES:
            return InferenceManager(2, mode="mult")
        return InferenceManager(0)
    tree = ast.parse(spec.strip(), mode="eval").body
    if not (isinstance(tree, ast.Call) and isinstance(tree.func, ast.Name)
            and tree.func.id == "InferenceManager"):
        raise ValueError(f"not an InferenceManager(...) call: {spec!r}")
    args = [ast.literal_eval(a) for a in tree.args]
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in tree.keywords}
    return InferenceManager(*args, **kwargs)
