"""The whole step's share of the card's bf16 dense peak: the model
operations of the profiled steps (``counts/``: GEMMs and the
aggregations' traversals a step needs, no recompute) over the profiled
span's wall time."""
from .. import counts


def read(tr):
    if tr.peaks is None or tr.span_s <= 0 or not tr.device_ops:
        return None
    fam = counts.family(tr.cfg["family"])
    flops = sum(fam.step_flops(tr.cfg, s) for s in tr.shapes)
    return 100.0 * flops / tr.span_s / tr.peaks["bf16_flops_per_s"]
