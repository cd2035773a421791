"""Predict bases and write .bas files (reference scripts/pred_basis.py).

    python -m lp_gnn_tpu_torch.pred_basis --dataset DS --exp_nm X \\
        --arch "GCN_FC(8,8,hids=1024,depth=3)" --fp16 1 \\
        --load_from runs/X/mdl.pth --split val [--device cpu]

``--load_from`` takes a torch ``mdl.pth`` state_dict (reference or this
package) or a JAX ``mdl.ckpt``. Runs on the GPU unless ``--device cpu``.
Graphs above ``--edge_num_thresh`` are served by exact sampled shards of
``--batch_size`` seeds, or edge-partitioned under ``--mesh_shape edge=K``.
"""
from __future__ import annotations

import logging

from . import pipeline
from .config import parse_args


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = parse_args(argv)
    return pipeline.stage_pred_basis(cfg)


if __name__ == "__main__":
    main()
