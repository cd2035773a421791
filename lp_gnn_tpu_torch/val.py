"""Classification metrics of the val split into the results table (the
twin of ``scripts/val.py``).

    python -m lp_gnn_tpu_torch.val --dataset DS --exp_nm X \\
        --arch "GCN_FC(8,8,hids=1024,depth=3)" --fp16 1 \\
        --load_from runs/X/mdl.pth [--device cpu]
"""
from __future__ import annotations

import logging

from . import pipeline
from .config import parse_args


def main(argv=None) -> float:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    return pipeline.stage_val(parse_args(argv))


if __name__ == "__main__":
    main()
