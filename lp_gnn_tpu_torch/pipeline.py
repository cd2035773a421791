"""Pipeline stages (counterpart of ``lp_gnn_tpu/pipeline.py``).

Each stage is a function over a :class:`Config`; the entry points at the
package's top call them. Stages communicate through the JAX package's
on-disk layout, with ``mdl.pth`` for ``mdl.ckpt`` and the results table in
``time.json`` (and ``time.h5`` where pandas imports)::

    {data_prefix}/{dataset}/...                    (prep.py: mps, cold
                                                    bases and logs, blobs)
    {log_prefix}/{exp_nm}/mdl.pth, train_state.pth, metrics.jsonl, args.json
    {log_prefix}/{exp_nm}/{pred-basis,opt-from-pred-basis}/*.bas
    {log_prefix}/{exp_nm}/log/{gnn-bas-0,warm-gate-calib,<cold copies>}/
    {log_prefix}/{exp_nm}/warm_gate.json, inf_time.json, time.json,
        summary.tex.csv, log-ing, log-prt, log-prt-err

The data-prep stages live in ``prep.py`` (their worker processes import no
torch) and are re-exported here.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import shutil

import numpy as np
import torch
import torch.distributed as dist

from .config import Config
from .data.dataset import LPDataset, split_train_val
from .device import resolve_device
from .infer.decode import parse_inference_manager
from .infer.predict import (_nnzs_for_decode, mesh_from_cfg, model_inference,
                            part_cache_dir, predict_and_write_bases,
                            runs_here, timed_inference, validation)
from .io.bas import write_bas_highs
from .models.convert import load_checkpoint
from .models.gcn import build_model
from .parallel.mesh import from_primary, is_primary
from .prep import (mps_files, solve_backend, stage_cvt_to_pkl,  # noqa: F401
                   stage_generate, stage_prep_data, stage_process,
                   stage_run_solver)
from .reporting.extract import (collect_results, extract_time,
                                format_summary, summarize, write_latex_csv)
from .train.trainer import run_exp
from .utils.misc import mkdir_p
from .utils.serialize import json_dump, json_load

TABLE = "time.json"


def _mps_path(cfg: Config, nm: str) -> str:
    mps = f"{cfg.dataset_prefix}/mps/{nm}.mps"
    if not osp.exists(mps) and osp.exists(mps + ".gz"):
        mps = mps + ".gz"
    return mps


def _table(cfg: Config) -> str:
    """The run's results table, started from the dataset's size stats and
    split if it is not there yet."""
    table = osp.join(cfg.log_dir, TABLE)
    if not osp.exists(table):
        LPDataset(cfg.dataset_processed_prefix).dump_size_info(table)
    return table


def _load_model(cfg: Config, ckpt_path: str | None, device) -> torch.nn.Module:
    """The arch on ``device`` in eval mode, with the weights of
    ``ckpt_path`` or ``--load_from`` (read by rank 0 alone under the
    contract, ``mesh.from_primary``); with neither (``None``), the seeded
    init (the control runs)."""
    model = build_model(cfg.arch_with_dtype(),
                        generator=torch.Generator().manual_seed(cfg.seed))
    src = ckpt_path or cfg.load_from
    if str(src).lower() != "none":   # rank 0's file, sent to every rank
        model.load_state_dict(from_primary(load_checkpoint, src))
    return model.to(device).eval()


# ------------------------------------------------------------------ L4 stages
def stage_train(cfg: Config) -> str:
    """Train and return the ``mdl.pth`` path (pipeline.py:198)."""
    return run_exp(cfg)


# ------------------------------------------------------------------ L5 stages
# two-sided 90% Student-t critical values by degrees of freedom (df 1-30;
# the normal 1.645 beyond), pipeline.py:206
_T90 = {1: 6.314, 2: 2.920, 3: 2.353, 4: 2.132, 5: 2.015, 6: 1.943,
        7: 1.895, 8: 1.860, 9: 1.833, 10: 1.812, 11: 1.796, 12: 1.782,
        13: 1.771, 14: 1.761, 15: 1.753, 16: 1.746, 17: 1.740, 18: 1.734,
        19: 1.729, 20: 1.725, 25: 1.708, 30: 1.697}


def _t_interval(xs) -> tuple[float, float, float]:
    """(mean, lo, hi): two-sided 90% t-interval on the mean of ``xs``."""
    n = len(xs)
    mean = float(np.mean(xs))
    if n < 2:
        return mean, -np.inf, np.inf
    sem = float(np.std(xs, ddof=1)) / np.sqrt(n)
    df = n - 1
    crit = _T90.get(df, min((_T90[c] for c in _T90 if c >= df),
                            default=1.645))
    return mean, mean - crit * sem, mean + crit * sem


def calibrate_warm_gate(model, train_ds: LPDataset, cfg: Config, inf_mng,
                        k: int | None = None) -> dict:
    """Measure the warm start's payback on TRAIN-split LPs, adaptively
    (pipeline.py:225).

    Decode each calibration LP with the configured inference manager,
    warm-start the solver from it and compare its iterations with the cold
    log of the prep stage. Starting at ``cfg.warm_gate_k`` LPs, keep
    sampling while the two-sided 90% t-interval on the mean improvement
    straddles 0, up to ``cfg.warm_gate_kmax``; DECLINE only when its upper
    bound is <= 0 (measured harm), PROCEED otherwise. A failed warm solve
    (a rejected basis included) scores impr = -1.0 and counts in
    ``failures``. Only training data is used (no val leakage). Over an edge
    mesh of ranks rank 0 decides, LP by LP, and tells the others, which
    take part in the forwards of the partitioned LPs; rank 0 alone solves,
    writes, and returns the gate (the others None). On a (dp, edge) grid
    of ranks row 0 does so, and the other rows return None at once."""
    solve_mps = solve_backend(cfg)
    method = cfg.normalized_lp_method()
    sfx = cfg.get_method_sfx()
    decode_fn, decode_kwargs = inf_mng.decode_fn(), inf_mng.decode_kwargs()
    calib_bas_dir = osp.join(cfg.log_dir, "warm-gate-calib")
    calib_log_dir = osp.join(cfg.log_dir, "log", "warm-gate-calib")
    if is_primary():
        mkdir_p(calib_bas_dir), mkdir_p(calib_log_dir)
    # the same inference configuration as the val predictions it gates
    mesh = mesh_from_cfg(cfg, next(model.parameters()).device)
    if mesh is not None and mesh.row != 0:
        return None   # a grid row other than 0 serves nothing
    ranks = mesh is not None and mesh.group is not None
    primary = is_primary()
    dist_cache: dict = {}
    part_dir = part_cache_dir(cfg)
    k_min = k if k is not None else int(cfg.warm_gate_k)
    k_max = max(int(cfg.warm_gate_kmax), k_min)
    lps, imprs = [], []
    failures = 0
    mean_impr, lo, hi = 0.0, -np.inf, np.inf
    for i in range(len(train_ds)):
        g = train_ds[i]
        step, cold_niter = "run", -1
        if primary:
            if len(lps) >= k_min:
                mean_impr, lo, hi = _t_interval(imprs)
                if lo > 0.0 or hi <= 0.0 or len(lps) >= k_max:
                    step = "stop"   # interval excludes 0, or budget exhausted
            cold_log = (f"{cfg.dataset_prefix}/log/"
                        f"{cfg.solver_prefix}no-bas{sfx}/{g.fn}.log")
            if step == "run" and osp.exists(cold_log):
                cold_niter, _ = extract_time(cold_log)
            if step == "run" and cold_niter < 0:
                step = "skip"
        if ranks:
            box = [step]
            dist.broadcast_object_list(box, src=0, group=mesh.group)
            step = box[0]
        if step == "stop":
            break
        if step == "skip" or not runs_here(g, cfg.edge_num_thresh, mesh):
            continue
        lc, lv = model_inference(model, g, cfg.edge_num_thresh,
                                 cfg.batch_size, cfg.arch_depth(), mesh=mesh,
                                 dist_cache=dist_cache, part_dir=part_dir)
        if not primary:
            continue
        logits = np.concatenate([lc, lv]).astype(np.float32)
        pred = decode_fn(logits, g.ncons,
                         nnzs=_nnzs_for_decode(g, decode_fn), **decode_kwargs)
        bas = osp.join(calib_bas_dir, f"{g.fn}.bas")
        write_bas_highs(bas, vbas=pred[g.ncons:], cbas=pred[:g.ncons])
        res = solve_mps(_mps_path(cfg, g.fn), method=method,
                        basis_in_path=bas,
                        log_path=osp.join(calib_log_dir, f"{g.fn}.log"))
        if res.niter >= 0 and not res.basis_rejected:
            impr = (cold_niter - res.niter) / max(cold_niter, 1)
        else:
            impr = -1.0   # failed warm start = one cold solve wasted
            failures += 1
        imprs.append(impr)
        lps.append({"fn": g.fn, "cold_niter": int(cold_niter),
                    "warm_niter": int(res.niter), "impr": float(impr)})
    if not primary:
        return None
    if imprs:
        mean_impr, lo, hi = _t_interval(imprs)
    # DECLINE only on measured harm; no data => proceed
    gate = {"proceed": not (imprs and hi <= 0.0),
            "mean_impr": mean_impr,
            "ci90": [float(lo), float(hi)], "k": len(lps),
            "k_min": k_min, "k_max": k_max, "failures": failures,
            "rule": "decline iff 90% t-interval upper bound <= 0",
            "lps": lps, "decode": inf_mng.get_basis_folder()}
    logging.info(
        "warm gate: %s (mean train impr %+.1f%%, 90%% CI [%+.1f%%, %+.1f%%] "
        "over %d LPs, %d failed warm solves)",
        "PROCEED" if gate["proceed"] else "DECLINE", 100 * mean_impr,
        100 * lo, 100 * hi, len(lps), failures)
    return gate


def stage_pred_basis(cfg: Config, ckpt_path: str | None = None) -> str:
    """Predict bases for the chosen split and write .bas files, calibrate
    the warm gate (``--warm_gate auto``), time the inference
    (pipeline.py:328; reference scripts/pred_basis.py main). Returns the
    basis folder. Under the ``LP_GNN_DIST_*`` contract with
    ``--mesh_shape edge=K`` over K ranks (joined by the entry point,
    ``pred_basis.py``) every rank runs its shard of each partitioned LP and
    rank 0 alone decodes and writes (``infer/predict.py``)."""
    device = resolve_device(cfg.device)
    if cfg.warm_gate not in ("auto", "off"):
        raise ValueError(f"--warm_gate {cfg.warm_gate!r}: 'auto' or 'off'")
    inf_mng = parse_inference_manager(cfg.inference_manager, cfg.dataset)
    out_dir = osp.join(cfg.log_dir, inf_mng.get_basis_folder())
    model = _load_model(cfg, ckpt_path, device)
    ds = LPDataset(cfg.dataset_processed_prefix, load_meta=True)
    train_ds, val_ds = split_train_val(ds, cfg.seed)
    target = val_ds if cfg.split == "val" else ds
    predict_and_write_bases(model, target, cfg, out_dir,
                            decode_fn=inf_mng.decode_fn(),
                            decode_kwargs=inf_mng.decode_kwargs())
    if cfg.warm_gate == "auto":
        gate = calibrate_warm_gate(model, train_ds, cfg, inf_mng)
        if gate is not None:
            json_dump(gate, osp.join(cfg.log_dir, "warm_gate.json"))
    # timing pass (pred_basis.py:158-176)
    timed_inference(model, target, cfg, _table(cfg) if is_primary() else None)
    return out_dir


# ------------------------------------------------------------------ L6 stages
def _gated_off(cfg: Config, basis_folder: str) -> bool:
    """Whether the warm gate declined the warm starts for this decode
    (pipeline.py:389-414): a gate calibrated for another decode is stale
    and ignored; no gate file means the warm starts proceed."""
    if cfg.warm_gate != "auto":
        return False
    gate_path = osp.join(cfg.log_dir, "warm_gate.json")
    if not osp.exists(gate_path):
        logging.warning("warm_gate auto but no warm_gate.json under %s "
                        "(predict stage not run?) — warm starts proceed",
                        cfg.log_dir)
        return False
    gate = json_load(gate_path)
    if gate.get("decode", basis_folder) != basis_folder:
        logging.warning(
            "warm_gate.json was calibrated for decode %r but this run uses "
            "%r — ignoring the stale gate (re-run the predict stage to "
            "recalibrate)", gate.get("decode"), basis_folder)
        return False
    if not gate.get("proceed", True):
        logging.warning(
            "warm gate DECLINED (mean train impr %+.1f%% over %d LPs) — val "
            "split solves cold; rerun with --warm_gate off to force the "
            "warm starts", 100 * gate.get("mean_impr", 0.0), gate.get("k", 0))
        return True
    return False


def stage_warm_start(cfg: Config) -> None:
    """Warm-start the solver from the predicted bases of the split
    (pipeline.py:361; reference scripts/run_solver_from_basis.py), cold
    where the warm gate declined. The split's LPs come from
    ``split_train_val`` (the JAX package reads them from ``time.h5``: the
    same names)."""
    solve_mps = solve_backend(cfg)
    inf_mng = parse_inference_manager(cfg.inference_manager, cfg.dataset)
    basis_folder = inf_mng.get_basis_folder()
    log_folder = inf_mng.get_log_folder()
    method = cfg.normalized_lp_method()
    if method != 1:
        log_folder += f"-m{method}"
    mkdir_p(f"{cfg.log_dir}/log/{log_folder}")
    # copy the data-side baseline logs into the run dir (extract_time.py:35-36)
    data_log = f"{cfg.dataset_prefix}/log"
    if osp.isdir(data_log):
        for d in os.listdir(data_log):
            dst = f"{cfg.log_dir}/log/{d}"
            if not osp.exists(dst):
                shutil.copytree(f"{data_log}/{d}", dst)
        ca = f"{cfg.log_dir}/log/{cfg.solver_prefix}ca-bas-m1"
        ca_alias = f"{cfg.log_dir}/log/{cfg.solver_prefix}ca-bas"
        if osp.isdir(ca) and not osp.exists(ca_alias):
            shutil.copytree(ca, ca_alias)
    gated_off = _gated_off(cfg, basis_folder)

    _table(cfg)
    ds = LPDataset(cfg.dataset_processed_prefix)
    _train_ds, val_ds = split_train_val(ds, seed=0)
    target = val_ds if cfg.split == "val" else ds
    for nm in [target.fns[i][:-len(".pk")] for i in target.indices()]:
        bas = f"{cfg.log_dir}/{basis_folder}/{nm}.bas"
        if not osp.exists(bas):
            logging.error("missing predicted basis %s", bas)
            continue
        out_bas = f"{cfg.log_dir}/opt-from-{basis_folder}/{nm}.bas"
        log = f"{cfg.log_dir}/log/{log_folder}/{nm}.log"
        res = solve_mps(_mps_path(cfg, nm), method=method,
                        basis_in_path=None if gated_off else bas,
                        basis_out_path=out_bas, log_path=log)
        logging.info("%s %s: %s %d iters",
                     "cold (gated)" if gated_off else "warm",
                     nm, res.status, res.niter)


# ------------------------------------------------------------------ L7 stages
def stage_val(cfg: Config, ckpt_path: str | None = None,
              wrt_converged: bool = False) -> float:
    """Classification metrics of the val split into the results table
    (pipeline.py:443; reference val.py main); with ``wrt_converged`` also
    against the bases the warm starts converged to (``cvg/*``)."""
    device = resolve_device(cfg.device)
    model = _load_model(cfg, ckpt_path, device)
    ds = LPDataset(cfg.dataset_processed_prefix)
    _train_ds, val_ds = split_train_val(ds, cfg.seed)
    table = _table(cfg)
    avg_acc = validation(model, val_ds, cfg, table)
    logging.info("avg val acc %.4f", avg_acc)
    if wrt_converged:
        cvg_acc = validation(model, val_ds, cfg, table, wrt_converged=True)
        logging.info("avg val acc wrt converged %.4f", cvg_acc)
    return avg_acc


def stage_extract(cfg: Config):
    """Aggregate every log into the results table, print the summary and
    write ``summary.tex.csv`` (pipeline.py:466; reference
    scripts/extract_time.py). Returns (rows, summary)."""
    rows = collect_results(cfg.log_dir, _table(cfg), cfg.solver_prefix)
    summary = summarize(rows)
    print(format_summary(summary))
    try:
        write_latex_csv(summary, osp.join(cfg.log_dir, "summary.tex.csv"))
    except (OSError, ValueError) as e:   # formatting never fails the run
        logging.warning("latex summary skipped: %s", e)
    return rows, summary


def run_train_test(cfg: Config) -> dict:
    """run_train_test.py: train -> predict -> warm start -> val -> extract
    (pipeline.py:485; reference run_train_test.py:11-19). Under the
    LP_GNN_DIST_* contract every rank trains and rank 0 alone goes on."""
    ckpt = stage_train(cfg)
    if not is_primary():
        return {"ckpt": ckpt}
    stage_pred_basis(cfg, ckpt)
    stage_warm_start(cfg)
    stage_val(cfg, ckpt, wrt_converged=True)
    rows, summary = stage_extract(cfg)
    return {"ckpt": ckpt, "summary": summary, "rows": rows}
