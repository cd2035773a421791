"""Predict bases and write .bas files (reference scripts/pred_basis.py).

    python -m lp_gnn_tpu_torch.pred_basis --dataset DS --exp_nm X \\
        --arch "GCN_FC(8,8,hids=1024,depth=3)" --fp16 1 \\
        --load_from runs/X/mdl.pth --split val [--device cpu]

``--load_from`` takes a torch ``mdl.pth`` state_dict (reference or this
package) or a JAX ``mdl.ckpt``. Runs on the GPU unless ``--device cpu``.
Graphs above ``--edge_num_thresh`` are served by exact sampled shards of
``--batch_size`` seeds, or edge-partitioned under ``--mesh_shape edge=K``:
all K shards on the one device, or, as K processes, one a rank, each given
``LP_GNN_DIST_COORD`` (host:port of rank 0), ``LP_GNN_DIST_NPROCS`` (K)
and ``LP_GNN_DIST_PROC_ID`` (its rank), shard k on rank k; rank 0 writes
the bases. Under ``--mesh_shape dp=D,edge=K`` over D*K ranks (the grid a
training run of those flags takes) row 0's K ranks serve that way and the
other rows run nothing.
"""
from __future__ import annotations

import logging

from . import pipeline
from .config import parse_args
from .device import resolve_device
from .parallel.mesh import (init_distributed, leave_distributed, log_routes,
                            parse_mesh_shape)


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = parse_args(argv)
    _, created = init_distributed(resolve_device(cfg.device))
    try:
        log_routes(parse_mesh_shape(cfg.mesh_shape or ""))
        return pipeline.stage_pred_basis(cfg)
    finally:
        leave_distributed(created)


if __name__ == "__main__":
    main()
