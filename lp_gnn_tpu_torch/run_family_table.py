"""The results table over the demo families (the twin of
``scripts/run_family_table.sh``).

    python -m lp_gnn_tpu_torch.run_family_table [--device cpu] [--seed 0] \\
        [--data_prefix lp-dataset] [--log_prefix runs]

For each family of ``FAMILIES``: ``run_prep_data`` (the demo tier, 40 LPs,
2 solver processes, ``--skip_exist 1``), then ``run_train_test``
(GCN_FC(8,8,hids=256,depth=3), 300 epochs, balanced CE, the ``auto``
decode and warm gate). Then, for ``GATE_OFF_FAMILIES``, the gate-off pass
on the trained checkpoint: ``pred_basis``, ``run_solver_from_basis`` and
``extract_time`` with ``InferenceManager(0, run=1)`` and ``--warm_gate
off``, into the run dir of the first pass (``pred-basis-1``,
``opt-from-pred-basis-1``, ``log/gnn-bas-1``). Last, one JSON line a
family with the columns of the JAX package's table (RESULTS.md:501), read
from the run's ``warm_gate.json`` and results table ``time.json``, and the
wall seconds of its three passes.

The script runs with ``LP_GNN_PLATFORM=cpu`` and reads each run's
``mdl.ckpt``; the twin trains and serves on the GPU unless ``--device
cpu`` and reads the run's ``mdl.pth``. Prep runs on the host's CPUs. The
gate-off pass's timing pass re-times ``inf_time``, as the script's does.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import os.path as osp
import time

from . import pipeline, run_prep_data
from .config import parse_args
from .device import resolve_device
from .infer.decode import parse_inference_manager
from .reporting.extract import summarize
from .utils.log import run_dir_logs, set_file_logger, set_file_logger_prt
from .utils.serialize import json_load

#: the script's constants, in its order
FAMILIES = ("miplib_like", "transport", "packing", "netflow", "svm", "stoch")
N_INSTANCES = 40
SIZE = "demo"
NUM_WORKERS = 2
SKIP_EXIST = 1
ARCH = "GCN_FC(8,8,hids=256,depth=3)"
EPOCHS = 300
LOSS = "balanced"
INFERENCE_MANAGER = "auto"
WARM_GATE = "auto"
#: the families whose gate declines, run again with the gate off
GATE_OFF_FAMILIES = ("svm", "stoch")
GATE_OFF_MANAGER = "InferenceManager(0, run=1)"
GATE_OFF_WARM_GATE = "off"
REJECTED = "WarmBasisRejected"


def exp_name(family: str, epochs: int = EPOCHS) -> str:
    """The script's run name, ``r4-$fam-ep300`` at its epochs."""
    return f"r4-{family}-ep{epochs}"


def gate_off_pass(argv: list[str], log_dir: str) -> None:
    """The script's gate-off commands (``pred_basis``,
    ``run_solver_from_basis``, ``extract_time``) with ``argv``, into
    ``log_dir``, the run dir of the first pass, taken as it is: the
    directory is never made again from the run's name."""
    cfg = parse_args(argv, make_log_dir=False)
    cfg.log_dir = log_dir
    set_file_logger(log_dir)
    set_file_logger_prt(log_dir)
    pipeline.stage_pred_basis(cfg)
    pipeline.stage_warm_start(cfg)
    pipeline.stage_extract(cfg)


def _finite(x):
    return None if x is None or math.isnan(x) else float(x)


def _rejected(log_dir: str, folder: str) -> int:
    """The warm logs of ``folder`` whose basis the solver rejected."""
    d = osp.join(log_dir, "log", folder)
    n = 0
    for f in sorted(os.listdir(d)) if osp.isdir(d) else ():
        with open(osp.join(d, f)) as fh:
            n += REJECTED in fh.read()
    return n


def family_row(family: str, log_dir: str, gate_off: bool) -> dict:
    """One family's row of the table (RESULTS.md:501), read from the run's
    files: the gate's decision and calibration mean (``warm_gate.json``);
    the val split's means of the cold and warm iterations, ``impr_niter``
    of the decode ``auto`` chose and, after the gate-off pass, of
    ``gnn-bas-1``; ``acc`` (``time.json``)."""
    folder = parse_inference_manager(INFERENCE_MANAGER,
                                     family).get_log_folder()
    off = parse_inference_manager(GATE_OFF_MANAGER).get_log_folder()
    gate = json_load(osp.join(log_dir, "warm_gate.json"))
    val = summarize(json_load(osp.join(log_dir, pipeline.TABLE)))["val"]

    def mean(col):
        return _finite(val[col][0]) if col in val else None

    row = {"family": family,
           "gate": {"proceed": bool(gate["proceed"]),
                    "mean_impr": _finite(gate["mean_impr"]),
                    "k": gate["k"], "failures": gate["failures"]},
           "cold_niter": mean("highs-no-bas/niter"), "decode": folder,
           "warm_niter": mean(f"{folder}/niter"),
           "impr": mean(f"{folder}/impr_niter"),
           "rejected": _rejected(log_dir, folder),
           "gate_off_niter": None, "gate_off_impr": None,
           "gate_off_rejected": None, "acc": mean("acc")}
    if gate_off:
        row.update(gate_off_niter=mean(f"{off}/niter"),
                   gate_off_impr=mean(f"{off}/impr_niter"),
                   gate_off_rejected=_rejected(log_dir, off))
    return row


def prep_argv(family: str, n_instances: int = N_INSTANCES,
              size: str = SIZE) -> list[str]:
    """The script's ``run_prep_data.py`` flags."""
    return ["--dataset", family, "--n_instances", str(n_instances),
            "--size", size, "--num_workers", str(NUM_WORKERS),
            "--skip_exist", str(SKIP_EXIST)]


def train_argv(family: str, epochs: int = EPOCHS,
               arch: str = ARCH) -> list[str]:
    """The script's ``run_train_test.py`` flags."""
    return ["--dataset", family, "--exp_nm", exp_name(family, epochs),
            "--arch", arch, "--epochs", str(epochs), "--loss", LOSS,
            "--inference_manager", INFERENCE_MANAGER, "--warm_gate", WARM_GATE]


def gate_off_argv(family: str, ckpt: str, epochs: int = EPOCHS,
                  arch: str = ARCH) -> list[str]:
    """The flags of the script's gate-off ``pred_basis.py`` (the other two
    commands take a part of them), ``ckpt`` for its ``--load_from``."""
    return ["--dataset", family, "--exp_nm", exp_name(family, epochs),
            "--arch", arch, "--load_from", ckpt,
            "--inference_manager", GATE_OFF_MANAGER,
            "--warm_gate", GATE_OFF_WARM_GATE]


def family_table(families=FAMILIES, n_instances: int = N_INSTANCES,
                 epochs: int = EPOCHS, arch: str = ARCH, size: str = SIZE,
                 device: str = "cuda", data_prefix: str = "lp-dataset",
                 log_prefix: str = "runs", seed: int = 0) -> list[dict]:
    """The script at its defaults (``main``); tests and ``chip_smoke.py``
    call it at a cut. Resolves the device before any prep (no card: it
    raises at once), prints one JSON line a family and returns the rows."""
    resolve_device(device)
    common = ["--data_prefix", data_prefix, "--log_prefix", log_prefix,
              "--seed", str(seed), "--device", device]
    runs, seconds = {}, {}
    for fam in families:
        logging.info("=== %s ===", fam)
        t0 = time.perf_counter()
        run_prep_data.main([*prep_argv(fam, n_instances, size), *common])
        t1 = time.perf_counter()
        with run_dir_logs():
            cfg = parse_args([*train_argv(fam, epochs, arch), *common])
            ckpt = pipeline.run_train_test(cfg)["ckpt"]
        runs[fam] = cfg.log_dir, ckpt
        seconds[fam] = {"prep": t1 - t0,
                        "run_train_test": time.perf_counter() - t1}
    # the gate-off rows of the repair-prone families, from their checkpoints
    gated = [fam for fam in families if fam in GATE_OFF_FAMILIES]
    for fam in gated:
        logging.info("=== %s gate-off ===", fam)
        log_dir, ckpt = runs[fam]
        t0 = time.perf_counter()
        with run_dir_logs():
            gate_off_pass([*gate_off_argv(fam, ckpt, epochs, arch), *common],
                          log_dir)
        seconds[fam]["gate_off"] = time.perf_counter() - t0
    rows = []
    for fam in families:
        row = {**family_row(fam, runs[fam][0], fam in gated),
               "run_dir": runs[fam][0], "seconds": seconds[fam]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    logging.info("family table done")
    return rows


def main(argv=None) -> list[dict]:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data_prefix", default="lp-dataset")
    ap.add_argument("--log_prefix", default="runs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return family_table(device=args.device, data_prefix=args.data_prefix,
                        log_prefix=args.log_prefix, seed=args.seed)


if __name__ == "__main__":
    main()
