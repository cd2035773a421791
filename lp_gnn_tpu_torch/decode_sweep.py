"""Decode-strategy sweep over ONE trained checkpoint: predict -> warm start
for each inference manager without retraining, then one report (the twin
of ``scripts/decode_sweep.py``).

The reference exposes the same choice as a CLI arg re-run per strategy
(val.py:167-197 InferenceManager; scripts/pred_basis.py:124); this driver
loops the strategies, so that a family study (does the sparsity-blend
decode fix repair-prone families?) is one command:

    python -m lp_gnn_tpu_torch.decode_sweep --dataset svm --exp_nm svm-ep300 \\
        --arch "GCN_FC(8,8,hids=256,depth=3)" \\
        --load_from runs/svm-ep300/mdl.pth \\
        --managers "InferenceManager(0,)" \\
                   "InferenceManager(2,mode='add',gnn_wei=0.5)" \\
                   "InferenceManager(2,mode='mult')"

Each manager writes its own basis and log folders
(``InferenceManager.get_basis_folder`` naming) into the SAME run dir, so
the closing ``stage_extract`` table (printed; ``main`` returns its rows
and summary) compares every strategy side by side against the shared
cold and crash baselines. ``--load_from`` is required (``mdl.pth`` or a
JAX ``mdl.ckpt``).
"""
from __future__ import annotations

import argparse
import dataclasses

from . import pipeline
from .config import parse_args

MANAGERS = ["InferenceManager(0,)",
            "InferenceManager(2,mode='add',gnn_wei=0.5)",
            "InferenceManager(2,mode='mult')"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--managers", type=str, nargs="+", default=MANAGERS)
    known, rest = ap.parse_known_args(argv)
    cfg = parse_args(rest)
    if cfg.load_from.lower() == "none":
        raise SystemExit("--load_from: a checkpoint is required")
    for mng in known.managers:
        c = dataclasses.replace(cfg, inference_manager=mng)
        print(f"=== decode {mng}", flush=True)
        pipeline.stage_pred_basis(c)
        pipeline.stage_warm_start(c)
    return pipeline.stage_extract(cfg)


if __name__ == "__main__":
    main()
