"""Configuration of the pipeline's stages (counterpart of
``lp_gnn_tpu/config.py``).

The fields and CLI flags the stages read, with the JAX package's defaults
and the same derived paths (``finalize``, config.py:186-200)::

    {data_prefix}/{dataset}/mps/*.mps[.gz]
    {data_prefix}/{dataset}/{solver_prefix}basis[-mM]/*.bas
    {data_prefix}/{dataset}/log/{solver_prefix}no-bas[-mM]/*.log
    {data_prefix}/{dataset}/{solver_prefix}inp_tgt[-mM]/{raw,processed}/*.pk
    {log_prefix}/{exp_nm}/...

plus ``--device`` (``cuda`` by default; ``cpu`` only when asked). Under
the ``LP_GNN_DIST_*`` contract only rank 0 makes the run dir. Edge
partitions are cached in ``.../inp_tgt[-mM]/partitions/`` beside
``processed/`` (``--part_cache``). A run dir made by ``parse_args`` gets
the reference's logs: ``log-ing``, ``log-prt`` and ``log-prt-err``
(config.py:286-292).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import re

from .utils.log import set_file_logger, set_file_logger_prt
from .utils.misc import increment_path, init_seeds, mkdir_p

LP_METHOD_MAP = {"dual": 1, "primal": 4}


@dataclasses.dataclass
class Config:
    # experiment
    exp_nm: str = "tmp"
    dataset: str = "None"
    data_prefix: str = "lp-dataset"
    log_prefix: str = "runs"
    solver_prefix: str = "highs-"
    exist_ok: int = 1
    seed: int = 0
    skip_exist: int = 0                    # prep stages: keep what exists
    chunk: str | None = None               # "k/N": the k-th of N shares of
                                           # the MPS files (run_solver.py:46)
    split: str = "val"                     # val | trainval
    # model
    arch: str = "GCN_FC(8,8,hids=128)"
    batch_size: int = 10240 * 8 * 4        # max seed nodes a sampled batch
    edge_num_thresh: float = 4e6 * 3       # full-graph vs sampled switch
    load_from: str = "None"
    fp16: int = 0                          # reference --fp16: bf16 compute
    # training (config.py:72-143)
    loss: str = "balanced"                 # unbalanced | balanced | focal
                                           # | critical
    opt: str = "adam"                      # adam | anything else: sgd
    lr: float = 1e-3
    epochs: int = 30
    num_workers: int = 0                   # prep: processes for the per-LP
                                           # solves and conversions
    graph_batch: int = 1                   # graphs a step, stacked into
                                           # one disjoint union per rank
    steps_per_call: int = 1                # K > 1: K steps a call, one
                                           # CUDA graph a stack on the card
    step_acc: int = 0                      # 1: decode accuracy every step;
                                           # 0: only on logged steps
    eval_every: int = 0                    # epochs between val passes
    trace: int = 0                         # 1: torch.profiler trace of
                                           # one epoch in {log_dir}/trace
    # solver / decode
    lp_method: int | str = 1               # 1=dual, 4=primal
    engine: str = "highs"                  # highs | native (the C++
                                           # simplex, built with g++ at
                                           # first use) | auto (native
                                           # where it is built, else highs)
    inference_manager: str = "InferenceManager(0,)"
    warm_gate: str = "auto"                # auto: calibrate the warm
                                           # starts' payback on train LPs
                                           # and decline them on measured
                                           # harm; off: always warm-start
    warm_gate_k: int = 5                   # calibration LPs before the gate
                                           # may decide
    warm_gate_kmax: int = 12               # calibration budget
    # parallelism
    mesh_shape: str = ""                   # edge=K: edge-partitioned forward
                                           # of graphs above edge_num_thresh
                                           # over K shards (shard k on
                                           # cuda:k with K cards visible,
                                           # else all K on the one device);
                                           # dp=K: training over K ranks
                                           # (the LP_GNN_DIST_* contract);
                                           # both: dp x edge training
    part_cache: int = 1                    # partition cache on disk
    cache_in_agg: int = 1                  # 1: the input conv's
                                           # aggregations computed once a
                                           # training graph (exact; not
                                           # for GEN); 0: every step
    # device
    device: str = "cuda"                   # cuda | cpu
    # derived (filled by finalize)
    dataset_prefix: str = ""
    dataset_processed_prefix: str = ""
    log_dir: str = ""

    def get_method_sfx(self) -> str:
        m = self.normalized_lp_method()
        return "" if m == 1 else f"-m{m}"

    def normalized_lp_method(self) -> int:
        m = self.lp_method
        if isinstance(m, str):
            m = LP_METHOD_MAP.get(m, m)
        return int(m)

    def arch_depth(self) -> int:
        """The depth the arch string names, 3 where it names none
        (config.py:162; reference train.py:108-110)."""
        m = re.findall(r"depth=(\d+)", self.arch)
        return int(m[0]) if m else 3

    def arch_with_dtype(self) -> str:
        """Arch string honoring --fp16 (bf16 compute, fp32 knowledge mask)."""
        if self.fp16 and "dtype" not in self.arch:
            base = self.arch.strip()[:-1]   # drop the closing ')'
            sep = "" if base.endswith("(") else ","
            return base + sep + "dtype='bfloat16')"
        return self.arch

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def finalize(self, make_log_dir: bool = True) -> "Config":
        self.lp_method = self.normalized_lp_method()
        if self.lp_method not in (1, 4):
            raise ValueError(f"lp_method {self.lp_method}: 1 (dual) or 4 (primal)")
        if not self.solver_prefix.endswith("-"):
            self.solver_prefix += "-"
        if self.solver_prefix != "highs-":
            raise ValueError(f"solver_prefix {self.solver_prefix!r}: only 'highs-'")
        self.dataset_prefix = os.path.join(self.data_prefix, self.dataset)
        self.dataset_processed_prefix = os.path.join(
            self.dataset_prefix,
            f"{self.solver_prefix}inp_tgt{self.get_method_sfx()}")
        log_dir = os.path.join(self.log_prefix, self.exp_nm)
        if make_log_dir:
            log_dir = increment_path(log_dir, exist_ok=bool(self.exist_ok))
            mkdir_p(log_dir)
        self.log_dir = log_dir
        init_seeds(self.seed)
        return self


_DERIVED = ("dataset_prefix", "dataset_processed_prefix", "log_dir")


def parse_args(argv=None, make_log_dir: bool = True, **defaults) -> Config:
    """CLI entry mirroring ``lp_gnn_tpu.config.parse_args``: one ``--flag``
    per field. Flags of the JAX CLI that this stage does not read are
    reported and ignored, as there."""
    cfg = Config(**defaults)
    parser = argparse.ArgumentParser(conflict_handler="resolve")
    for f in dataclasses.fields(cfg):
        if f.name in _DERIVED:
            continue
        v = getattr(cfg, f.name)
        tp = type(v) if v is not None and not isinstance(v, bool) else str
        if f.name == "lp_method":
            tp = str   # accepts 1/4 and 'dual'/'primal'
        parser.add_argument(f"--{f.name}", type=tp, default=v)
    known, unknown = parser.parse_known_args(argv)
    if unknown:
        logging.warning("unknown args: %s", unknown)
    for k, v in vars(known).items():
        setattr(cfg, k, v)
    # only rank 0 of a dp run makes the run dir and its logs (torch is
    # imported here, not with the module: prep's solver processes import
    # this module and no torch)
    from .parallel.mesh import is_primary
    make_log_dir = make_log_dir and is_primary()
    cfg.finalize(make_log_dir=make_log_dir)
    if make_log_dir:
        # the run dir's logs (reference Environment, utils.py:452-497)
        set_file_logger(cfg.log_dir)
        set_file_logger_prt(cfg.log_dir)
    return cfg
