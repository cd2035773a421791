"""Train a model (the twin of the repo's ``train.py``; reference train.py).

    python -m lp_gnn_tpu_torch.train --dataset DS --exp_nm X \\
        --arch "GCN_FC(8,8,hids=1024,depth=3)" --fp16 1 --loss balanced \\
        --epochs 800 [--load_from runs/X/mdl.pth] [--device cpu]

Writes ``{log_dir}/mdl.pth``, ``train_state.pth``, ``metrics.jsonl`` and
``args.json`` and prints the ``mdl.pth`` path. Runs on the GPU unless
``--device cpu``. Graphs above ``--edge_num_thresh`` train on sampled
subgraphs (``--batch_size`` seeds each); ``--graph_batch B`` steps B
graphs of one stack key at a time; ``--mesh_shape dp=K`` runs as K
processes, one a rank, each given ``LP_GNN_DIST_COORD`` (host:port of rank
0), ``LP_GNN_DIST_NPROCS`` (K) and ``LP_GNN_DIST_PROC_ID`` (its rank).
"""
from __future__ import annotations

import logging

from .. import pipeline
from ..config import parse_args


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = parse_args(argv)
    path = pipeline.stage_train(cfg)
    print(path)
    return path


if __name__ == "__main__":
    main()
