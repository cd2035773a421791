"""Warm-start the solver from the predicted bases of a run (the twin of
``scripts/run_solver_from_basis.py``).

    python -m lp_gnn_tpu_torch.run_solver_from_basis --dataset DS --exp_nm X
"""
from __future__ import annotations

import logging

from . import pipeline
from .config import parse_args


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    pipeline.stage_warm_start(parse_args(argv))


if __name__ == "__main__":
    main()
