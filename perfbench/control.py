"""The readings a cell's limits are set from (``limits/<cell>.json``).

    python -m perfbench.control --workload <cell> --seeds 1,2,3 \\
        --what sound,control,half_batch

For each seed, in one process, the readings (``check.readings``) of
each kind against the exact reference's record of the cell's first
steps, fed the dropout masks that kind applied:

- ``sound``: the program, as a run drives it (its set-up and first steps;
  the readings need no window);
- ``control``: the reference itself computed in float8 (e4m3 forward,
  e5m2 gradients) in the program's place, the precision below the bf16
  the configurations state;
- ``half_batch``: the program with half of each side's nodes left out of
  the loss, the mean taken over the rest;
- ``frozen``: the program with a step that leaves its state unchanged;
- ``loss_off``: the program reporting a loss 10% off the one it trains on.

One JSON line a seed and kind. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import torch

from . import check, lpgen, manifest, seeds, system, weights
from .reference import common, family as reference_family

KINDS = ("sound", "control", "half_batch", "frozen", "loss_off")


def half_batch(loss_fn):
    """``loss_fn`` over the first half of each side's seed nodes only."""
    def loss(lc, lv, y_s, y_t, ms, mt, **kw):
        def half(mask):
            keep = torch.arange(mask.shape[0], device=mask.device) < \
                mask.shape[0] // 2
            return mask & keep
        return loss_fn(lc, lv, y_s, y_t, half(ms), half(mt), **kw)
    return loss


def loss_off(loss_fn):
    """``loss_fn`` whose reported value is 10% off, its gradient as it was."""
    def loss(*a, **kw):
        value = loss_fn(*a, **kw)
        return value + 0.1 * value.detach()
    return loss


@contextlib.contextmanager
def fault(kind: str):
    """The program broken underneath as ``kind`` says (nothing for
    ``sound``): the loss in ``LOSS_REGISTRY`` wrapped, or the optimizer's
    step a no-op."""
    from lp_gnn_tpu_torch.train import losses

    saved = dict(losses.LOSS_REGISTRY)
    step = torch.optim.Adam.step
    try:
        if kind == "half_batch":
            losses.LOSS_REGISTRY.update(
                {k: half_batch(v) for k, v in saved.items()})
        elif kind == "loss_off":
            losses.LOSS_REGISTRY.update(
                {k: loss_off(v) for k, v in saved.items()})
        elif kind == "frozen":
            torch.optim.Adam.step = lambda self, closure=None: None
        yield
    finally:
        losses.LOSS_REGISTRY.clear()
        losses.LOSS_REGISTRY.update(saved)
        torch.optim.Adam.step = step


def program_record(cell: manifest.Cell, seed: int, lps: list, device,
                   kind: str = "sound") -> check.Record:
    """The program's record of the cell's first steps, as a run's set-up
    makes it, with ``kind``'s fault planted."""
    family = reference_family(cell.config["family"])
    w0 = weights.draw(family.param_spec(cell.config), seed, device)
    with fault(kind):
        sut = system.Trainer(cell.config, lps, w0,
                             seeds.derive(seed, "dropout"), device)
        rec = sut.first_steps(first_order(cell, seed), w0)
    del sut
    _free(device)
    return rec


def reference_record(cell: manifest.Cell, seed: int, lps: list, device,
                     masks, rnd=common.exact) -> check.Record:
    """The reference's record of the cell's first steps in ``rnd``'s
    precision, dropout's masks from ``masks`` (``common.FedMasks`` or
    ``common.DrawnMasks``)."""
    family = reference_family(cell.config["family"])
    w0 = weights.draw(family.param_spec(cell.config), seed, device)
    common.exact_fp32()
    rec = common.train_steps(family, cell.config, w0, lps,
                             first_order(cell, seed), masks, rnd=rnd)
    _free(device)
    return rec


def drawn_masks(cell: manifest.Cell, seed: int, device) -> common.DrawnMasks:
    """Masks drawn from the dropout seed a run hands the program."""
    return common.DrawnMasks(cell.config["dropout"], torch.Generator(
        device=device).manual_seed(seeds.derive(seed, "dropout")))


def first_order(cell: manifest.Cell, seed: int) -> list[int]:
    order = lpgen.StepOrder(int(cell.traffic["graphs"]), seed)
    return [order.next() for _ in range(int(cell.traffic["warmup_steps"]))]


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(cell: manifest.Cell, seed: int, kinds, device):
    """``{kind: readings}`` of one seed."""
    lps = lpgen.draw_lps(cell.traffic, seed)
    out = {}
    for kind in kinds:
        if kind == "control":
            drawn = drawn_masks(cell, seed, device)
            rec = reference_record(cell, seed, lps, device, drawn,
                                   rnd=common.fp8)
            rec.masks = drawn.kept
        else:
            rec = program_record(cell, seed, lps, device, kind)
        ref = reference_record(cell, seed, lps, device,
                               common.FedMasks(rec.masks))
        out[kind] = check.readings(rec, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers >= 0")
    ap.add_argument("--what", default="sound",
                    help=f"comma-separated, of {', '.join(KINDS)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kinds = args.what.split(",")
    if any(k not in KINDS for k in kinds):
        ap.error(f"--what: of {KINDS}")
    cell = manifest.cell(args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind, read in readings(cell, seed, kinds, device).items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "kind": kind, **read}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
