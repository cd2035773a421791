"""Cold-solve every instance and run the crash-basis baseline (the twin of
``scripts/run_solver.py``).

    python -m lp_gnn_tpu_torch.run_solver --dataset DS [--lp_method 4] \\
        [--num_workers 8] [--skip_exist 1] [--chunk k/N]
"""
from __future__ import annotations

import logging

from . import prep
from .config import parse_args


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    prep.stage_run_solver(parse_args(argv, make_log_dir=False))


if __name__ == "__main__":
    main()
