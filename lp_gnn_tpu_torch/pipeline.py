"""Pipeline stages (counterpart of ``lp_gnn_tpu/pipeline.py``).

Ported so far: ``stage_train`` (:198), the single-device trainer, and
``stage_pred_basis`` (:328-357), the serving path. They write the same
on-disk layout as the JAX package, with ``mdl.pth`` for ``mdl.ckpt``::

    {log_prefix}/{exp_nm}/mdl.pth, train_state.pth, metrics.jsonl, args.json
    {log_prefix}/{exp_nm}/{pred-basis}/*.bas, *.bas.sort
    {log_prefix}/{exp_nm}/inf_time.json    (and time.h5 where pandas is)

The other stages (generate, solve, warm start, val, extract) wait for later
slices; ROADMAP.md lists them in order.
"""
from __future__ import annotations

import os.path as osp

import torch

from .config import Config
from .data.dataset import LPDataset, split_train_val
from .device import resolve_device
from .infer.decode import parse_inference_manager
from .infer.predict import predict_and_write_bases, timed_inference
from .models.convert import load_checkpoint
from .models.gcn import build_model
from .train.trainer import run_exp
from .utils.serialize import have_pandas


def stage_train(cfg: Config) -> str:
    """Train and return the ``mdl.pth`` path (pipeline.py:198)."""
    return run_exp(cfg)


def stage_pred_basis(cfg: Config, ckpt_path: str | None = None) -> str:
    """Predict bases for the chosen split and write .bas files
    (reference scripts/pred_basis.py main). Returns the basis folder."""
    device = resolve_device(cfg.device)
    if cfg.warm_gate != "off":
        raise NotImplementedError(
            f"--warm_gate {cfg.warm_gate}: the warm-start gate calibrates "
            "with the LP solver, which is not ported to lp_gnn_tpu_torch yet "
            "(ROADMAP.md, queue item 2: warm start, solver and reporting). "
            "Pass --warm_gate off.")
    inf_mng = parse_inference_manager(cfg.inference_manager, cfg.dataset)
    out_dir = osp.join(cfg.log_dir, inf_mng.get_basis_folder())
    model = build_model(cfg.arch_with_dtype(),
                        generator=torch.Generator().manual_seed(cfg.seed))
    src = ckpt_path or cfg.load_from
    if str(src).lower() != "none":
        model.load_state_dict(load_checkpoint(src))
    # with no checkpoint the weights stay the seeded init (control runs)
    model.to(device).eval()
    ds = LPDataset(cfg.dataset_processed_prefix, load_meta=True)
    _train_ds, val_ds = split_train_val(ds, cfg.seed)
    target = val_ds if cfg.split == "val" else ds
    predict_and_write_bases(model, target, cfg, out_dir,
                            decode_fn=inf_mng.decode_fn(),
                            decode_kwargs=inf_mng.decode_kwargs())
    # timing pass (pred_basis.py:158-176)
    dump_info = None
    if have_pandas():
        dump_info = osp.join(cfg.log_dir, "time.h5")
        if not osp.exists(dump_info):
            LPDataset(cfg.dataset_processed_prefix).dump_size_info(dump_info)
    timed_inference(model, target, cfg, dump_info)
    return out_dir
