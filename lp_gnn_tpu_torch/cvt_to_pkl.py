"""MPS + optimal basis -> raw graph blobs (the twin of
``scripts/cvt_to_pkl.py``).

    python -m lp_gnn_tpu_torch.cvt_to_pkl --dataset DS [--num_workers 8]
"""
from __future__ import annotations

import logging

from . import prep
from .config import parse_args


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    prep.stage_cvt_to_pkl(parse_args(argv, make_log_dir=False))


if __name__ == "__main__":
    main()
