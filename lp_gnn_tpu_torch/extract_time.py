"""Aggregate a run's solver logs into its results table and print the
summary (the twin of ``scripts/extract_time.py``).

    python -m lp_gnn_tpu_torch.extract_time --dataset DS --exp_nm X
"""
from __future__ import annotations

import logging

from . import pipeline
from .config import parse_args


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    return pipeline.stage_extract(parse_args(argv))


if __name__ == "__main__":
    main()
