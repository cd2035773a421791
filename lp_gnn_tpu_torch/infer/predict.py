"""Prediction and timing passes (counterpart of ``lp_gnn_tpu/infer/predict.py``).

``model_inference`` (:116) runs the full-graph forward of one LP on the
model's device. The JAX package's two other branches, sampled shards for
graphs above ``edge_num_thresh`` (:142-162) and edge-partitioned inference
under ``--mesh_shape edge=K`` (:133-137), are not ported yet: they raise and
name the ROADMAP item.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import time

import numpy as np
import torch
from torch import nn

from ..data.dataset import BipartiteGraph, LPDataset
from ..data.graph import GraphTensors
from ..io.bas import write_bas_highs
from ..utils.serialize import df_dump, df_load, json_dump
from .decode import inference_gnn


def check_mesh(cfg) -> None:
    """``--mesh_shape edge=K`` (K > 1) selects edge-partitioned inference,
    which is not ported."""
    spec = cfg.mesh_shape or ""
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if k.strip() == "edge" and int(v) > 1:
            raise NotImplementedError(
                "--mesh_shape edge=K (edge-partitioned inference) is not "
                "ported to lp_gnn_tpu_torch yet (ROADMAP.md, queue item 7: "
                "edge partition)")


def model_inference(model: nn.Module, g: BipartiteGraph,
                    edge_num_thresh: float = np.inf):
    """Exact logits for every node of one graph (reference val.py:12-41):
    one full-graph forward on the model's device. Returns
    (logit_cons (m, 3), logit_vars (n, 3)) numpy fp32."""
    if g.nnz > edge_num_thresh:
        raise NotImplementedError(
            f"{g.fn}: {g.nnz} edges > edge_num_thresh={edge_num_thresh:g} "
            "takes the sampled-shard inference, which is not ported to "
            "lp_gnn_tpu_torch yet (ROADMAP.md, queue item 5: sampling)")
    device = next(model.parameters()).device
    gt = GraphTensors.from_graph(g, device)
    with torch.inference_mode():
        lc, lv = model(gt)
    return lc.cpu().numpy(), lv.cpu().numpy()


def predict_and_write_bases(model: nn.Module, ds: LPDataset, cfg,
                            out_dir: str, decode_fn=inference_gnn,
                            decode_kwargs: dict | None = None) -> None:
    """Decode every graph and write HiGHS .bas + .sort files
    (reference scripts/pred_basis.py:70-111)."""
    check_mesh(cfg)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(ds)):
        g = ds[i]
        lc, lv = model_inference(model, g, cfg.edge_num_thresh)
        logits = np.concatenate([lc, lv]).astype(np.float32)
        m = g.ncons
        pred = decode_fn(logits, m, nnzs=_nnzs_for_decode(g, decode_fn),
                         **(decode_kwargs or {}))
        fn = osp.join(out_dir, f"{g.fn}.bas")
        write_bas_highs(fn, vbas=pred[m:], cbas=pred[:m])
        _write_sort_vars(fn + ".sort", logits, m)


def _nnzs_for_decode(g: BipartiteGraph, decode_fn):
    if decode_fn is inference_gnn:
        return None
    # sparsity decode: slacks count 1, structural vars their column nnz
    # (reference pred_basis.py:71-77)
    deg = np.zeros(g.nvars)
    np.add.at(deg, g.col, 1)
    return np.concatenate([np.ones(g.ncons), deg])


def _write_sort_vars(fn: str, logits: np.ndarray, m: int):
    """P(basic) sidecar for Bixby-crash experiments
    (reference pred_basis.py:57-67): vars first, then cons."""
    x = logits - logits.max(-1, keepdims=True)
    e = np.exp(x)
    pr = e / e.sum(-1, keepdims=True)
    pv, pc = pr[m:, 1], pr[:m, 1]
    with open(fn, "w") as f:
        f.write(f"{len(pv)} \n")
        f.write(" ".join(str(float(v)) for v in pv) + "\n")
        f.write(f"{len(pc)} \n")
        f.write(" ".join(str(float(v)) for v in pc) + "\n")


def timed_inference(model: nn.Module, ds: LPDataset, cfg,
                    dump_info: str | None = None) -> dict:
    """Pure-inference timing pass -> per-LP ``inf_time`` in seconds
    (reference pred_basis.py:158-176).

    ``inf_time`` covers the forward (graph tensors built on the device
    included, as the JAX package's includes ``pad_graph``) plus the top-m
    decode: the median of 3 timed passes after one warm-up, each ending with
    ``torch.cuda.synchronize()`` on the card. Written to
    ``{log_dir}/inf_time.json`` and, where pandas is importable, into the
    ``inf_time`` column of ``dump_info`` (``time.h5``)."""
    check_mesh(cfg)
    device = next(model.parameters()).device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = {}
    for i in range(len(ds)):
        g = ds[i]
        model_inference(model, g, cfg.edge_num_thresh)   # warm-up
        sync()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            lc, lv = model_inference(model, g, cfg.edge_num_thresh)
            inference_gnn(np.concatenate([lc, lv]), g.ncons)
            sync()
            reps.append(time.perf_counter() - t0)
        times[g.fn] = sorted(reps)[1]
        logging.info("inf_time %s %.6f s", g.fn, times[g.fn])
    json_dump({"device": str(device), "inf_time": times},
              osp.join(cfg.log_dir, "inf_time.json"))
    if dump_info and osp.exists(dump_info):
        df = df_load(dump_info)
        for fn, t in times.items():
            df.loc[df.fn == fn, "inf_time"] = t
        df_dump(df, dump_info)
    return times
