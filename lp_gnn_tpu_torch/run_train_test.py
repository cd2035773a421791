"""End to end: train -> predict (and the warm gate) -> warm start -> val
-> report (the twin of the repo's ``run_train_test.py``).

    python -m lp_gnn_tpu_torch.run_train_test --dataset mirp_bench \\
        --exp_nm X --arch "GCN_FC(8,8,hids=1024,depth=3)" --fp16 1 \\
        --epochs 800 --loss balanced [--device cpu]

Needs the dataset that ``run_prep_data`` prepares. Prints the per-split
summary; the run dir holds ``mdl.pth``, the bases, the logs,
``warm_gate.json`` and the results table ``time.json``. Runs on the GPU
unless ``--device cpu``.
"""
from __future__ import annotations

import logging

from . import pipeline
from .config import parse_args


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    return pipeline.run_train_test(parse_args(argv))


if __name__ == "__main__":
    main()
