"""Dataset preparation: [generate] -> cold solve -> raw blobs -> processed
blobs (the twin of the repo's ``run_prep_data.py``; reference
run_prep_data.py).

    python -m lp_gnn_tpu_torch.run_prep_data --dataset mirp_bench \\
        --family mirp_like --size bench --n_instances 40 [--num_workers 8]

``--n_instances 0`` (the default) uses the MPS files already under
``{data_prefix}/{dataset}/mps``. Runs on the host's CPUs only.
"""
from __future__ import annotations

import argparse
import logging

from . import prep
from .config import parse_args
from .data.generator import SIZES


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_instances", type=int, default=0,
                    help="generate this many instances first (0 = use "
                         "existing mps)")
    ap.add_argument("--family", type=str, default=None)
    ap.add_argument("--size", type=str, default="demo")
    known, rest = ap.parse_known_args(argv)
    cfg = parse_args(rest, make_log_dir=False)
    family = known.family or cfg.dataset.split("-")[0]
    kwargs = SIZES.get(family, {}).get(known.size, {})
    prep.stage_prep_data(cfg, family=family, n_instances=known.n_instances,
                         **kwargs)


if __name__ == "__main__":
    main()
