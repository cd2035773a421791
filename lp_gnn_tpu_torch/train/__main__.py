"""Train a model (the twin of the repo's ``train.py``; reference train.py).

    python -m lp_gnn_tpu_torch.train --dataset DS --exp_nm X \\
        --arch "GCN_FC(8,8,hids=1024,depth=3)" --fp16 1 --loss balanced \\
        --epochs 800 [--load_from runs/X/mdl.pth] [--device cpu]

Writes ``{log_dir}/mdl.pth``, ``train_state.pth``, ``metrics.jsonl`` and
``args.json`` and prints the ``mdl.pth`` path. Runs on the GPU unless
``--device cpu``.
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
