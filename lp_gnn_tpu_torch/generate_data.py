"""Generate a synthetic LP family into the dataset layout (the twin of
``scripts/generate_data.py``).

    python -m lp_gnn_tpu_torch.generate_data --dataset mirp_like \\
        --n_instances 40 [--family mirp_like] [--size small|demo|bench]
"""
from __future__ import annotations

import argparse

from . import prep
from .config import parse_args
from .data.generator import SIZES


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_instances", type=int, default=40)
    ap.add_argument("--family", type=str, default=None)
    ap.add_argument("--size", type=str, default="demo")
    known, rest = ap.parse_known_args(argv)
    cfg = parse_args(rest, make_log_dir=False)
    family = known.family or cfg.dataset.split("-")[0]
    kwargs = SIZES.get(family, {}).get(known.size, {})
    fns = prep.stage_generate(cfg, family, known.n_instances, **kwargs)
    print(f"wrote {len(fns)} instances under {cfg.dataset_prefix}/mps")
    return fns


if __name__ == "__main__":
    main()
