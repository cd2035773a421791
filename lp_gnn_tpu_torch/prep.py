"""Data preparation: generate -> cold solve -> raw blobs -> processed blobs
(the data-prep stages of ``lp_gnn_tpu/pipeline.py:45-194``; reference
run_prep_data.py and scripts/{generate_mps_files,run_solver,cvt_to_pkl}.py).

Kept apart from ``pipeline.py`` so that the processes ``--num_workers K``
starts import no torch: they only parse MPS files, solve and write. The
pool is made from the ``spawn`` context, so a parent that has initialized
CUDA forks nothing. On-disk layout (the JAX package's)::

    {data_prefix}/{dataset}/mps/*.mps
    {data_prefix}/{dataset}/{sv}basis[-mM]/*.bas         cold optimal bases
    {data_prefix}/{dataset}/log/{sv}no-bas[-mM]/*.log    cold logs
    {data_prefix}/{dataset}/{sv}ca-init-bas-m1/*.bas     crash bases
    {data_prefix}/{dataset}/log/{sv}ca-bas-m1/*.log      crash warm-start logs
    {data_prefix}/{dataset}/{sv}inp_tgt[-mM]/{raw,processed}/*.pk
    {data_prefix}/{dataset}/{sv}inp_tgt[-mM]/size.json

With one ``--seed`` and one ``--engine`` the MPS files, cold ``.bas``
files, logs (all but the timed lines: "run time", and the native engine's
"time elapsed for factorize") and blobs are the JAX package's, byte for
byte.
"""
from __future__ import annotations

import glob
import logging
import multiprocessing
import os.path as osp
from functools import partial

import numpy as np

from .config import Config
from .data.dataset import LPDataset, process_raw_dir
from .data.generator import generate_dataset
from .io.bas import check_lb, check_ub, read_bas, write_bas_highs
from .io.mps import read_mps
from .reporting.extract import extract_time
from .solver.crash import bixby_crash_basis
from .utils.misc import extract_fn, mkdir_p, split_out_chunk
from .utils.serialize import msgpack_dump

ENGINES = ("highs", "auto", "native")


def mps_files(cfg: Config) -> list[str]:
    """The dataset's MPS files (``.mps``, else ``.mps.gz``) in name order,
    the ``--chunk`` share of them (pipeline.py:45)."""
    fns = sorted(glob.glob(f"{cfg.dataset_prefix}/mps/*.mps"),
                 key=lambda nm: (len(nm), nm))
    if not fns:
        fns = sorted(glob.glob(f"{cfg.dataset_prefix}/mps/*.mps.gz"),
                     key=lambda nm: (len(nm), nm))
    if not fns:
        raise ValueError(f"no mps under {cfg.dataset_prefix}/mps")
    return split_out_chunk(fns, cfg.chunk)


def solve_backend(cfg: Config):
    """The solver engine's ``solve_mps`` (pipeline.py:58): ``highs`` (the
    bridge over scipy's HiGHS); ``native`` (the C++ simplex engine, built
    with g++ into ``_build/`` here first where it is not there; a failed
    build raises); ``auto`` = ``native`` where its library is built, else
    ``highs``. The library is loaded, not built, where it exists, so the
    solver processes of a pool started after this call only load it."""
    if cfg.engine not in ENGINES:
        raise ValueError(f"--engine {cfg.engine!r}: one of {ENGINES}")
    from .solver import native
    if cfg.engine == "native":
        native.build()
    if cfg.engine == "native" or (cfg.engine == "auto" and native.available()):
        return native.solve_mps
    from .solver.highs_bridge import solve_mps
    return solve_mps


def _pool_map(fn, items: list, workers: int) -> None:
    """``fn`` over ``items`` in ``workers`` spawned processes, or here."""
    if workers and workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            pool.map(fn, items)
        return
    for it in items:
        fn(it)


# ------------------------------------------------------------------- stages
def stage_generate(cfg: Config, family: str | None = None,
                   n_instances: int = 40, **kwargs) -> list[str]:
    """Generate a synthetic LP family into the dataset layout
    (pipeline.py:69)."""
    return generate_dataset(cfg.dataset, cfg.data_prefix,
                            n_instances=n_instances, seed=cfg.seed,
                            family=family, **kwargs)


def stage_run_solver(cfg: Config) -> None:
    """Cold-solve every instance, save its optimal basis and log, and run
    the crash-basis warm-start baseline (pipeline.py:77; reference
    scripts/run_solver.py); ``--num_workers K`` fans the LPs out over K
    processes."""
    solve_backend(cfg)   # builds the engine, or fails, once, before the pool
    _pool_map(partial(solve_one_cold, cfg=cfg), mps_files(cfg),
              cfg.num_workers)


def solve_one_cold(mps: str, cfg: Config) -> None:
    """One LP's cold solve and crash baseline (pipeline.py:94)."""
    solve_mps = solve_backend(cfg)
    method = cfg.normalized_lp_method()
    sfx = cfg.get_method_sfx()
    path = cfg.dataset_prefix
    nm = extract_fn(mps)
    bas = f"{path}/{cfg.solver_prefix}basis{sfx}/{nm}.bas"
    log = f"{path}/log/{cfg.solver_prefix}no-bas{sfx}/{nm}.log"
    if cfg.skip_exist and osp.exists(log) and osp.exists(bas):
        return
    res = solve_mps(mps, method=method, basis_out_path=bas, log_path=log)
    logging.info("cold %s: %s %d iters", nm, res.status, res.niter)
    # crash-basis baseline (run_solver.py:56)
    lp = read_mps(mps)
    colb, rowb = bixby_crash_basis(lp)
    ca_bas = f"{path}/{cfg.solver_prefix}ca-init-bas-m1/{nm}.bas"
    write_bas_highs(ca_bas, vbas=colb, cbas=rowb)
    ca_log = f"{path}/log/{cfg.solver_prefix}ca-bas-m1/{nm}.log"
    solve_mps(mps, method=method, basis_in_path=ca_bas, log_path=ca_log)


def stage_cvt_to_pkl(cfg: Config) -> None:
    """MPS + optimal .bas -> raw/*.pk graph blobs (pipeline.py:115;
    reference scripts/cvt_to_pkl.py:220-277), one process a LP with
    ``--num_workers``."""
    mkdir_p(f"{cfg.dataset_processed_prefix}/raw")
    _pool_map(partial(cvt_one, cfg=cfg), mps_files(cfg), cfg.num_workers)


def cvt_one(mps: str, cfg: Config) -> None:
    """One LP's raw blob: its data in the reference's form and its labels
    from the cold optimal basis (pipeline.py:133)."""
    sfx = cfg.get_method_sfx()
    path = cfg.dataset_prefix
    nm = extract_fn(mps)
    dst = f"{cfg.dataset_processed_prefix}/raw/{nm}.pk"
    if cfg.skip_exist and osp.exists(dst):
        return
    bas_fn = f"{path}/{cfg.solver_prefix}basis{sfx}/{nm}.bas"
    if not osp.exists(bas_fn):
        logging.error("no basis for %s — skipped", nm)
        return
    # labels only from instances the cold solve actually optimized
    cold_log = f"{path}/log/{cfg.solver_prefix}no-bas{sfx}/{nm}.log"
    if osp.exists(cold_log):
        iters, _tm = extract_time(cold_log)
        if iters < 0:
            logging.error("cold solve of %s not Optimal — skipped", nm)
            return
    lp = read_mps(mps)
    b_u = lp.b_u.copy()
    b_l = lp.b_l.copy()
    u = lp.ub.copy()
    l = lp.lb.copy()
    b_u[b_u > 1e308] = np.inf
    b_l[b_l < -1e308] = -np.inf
    u[u > 1e308] = np.inf
    l[l < -1e308] = -np.inf
    con_lbls, var_lbls = read_bas(bas_fn, lp.con_nms, lp.var_nms)
    con_lbls = np.asarray(con_lbls, dtype=np.int64)
    var_lbls = np.asarray(var_lbls, dtype=np.int64)
    check_lb(var_lbls, l, lp.var_nms)
    check_ub(var_lbls, u, lp.var_nms)
    # constraint labels must be consistent with infinite row bounds
    # (cvt_to_pkl.py:257-258)
    if (con_lbls[b_l == -np.inf] == 0).any() or \
            (con_lbls[b_u == np.inf] == 2).any():
        raise ValueError(f"{nm}: row labels contradict infinite row bounds")
    A = lp.A.tocoo()
    msgpack_dump(
        [lp.c, b_l, (A.row, A.col, A.data), b_u, l, u,
         con_lbls, var_lbls,
         [str(s) for s in lp.con_nms], [str(s) for s in lp.var_nms]],
        dst)


def stage_process(cfg: Config) -> None:
    """raw -> processed feature graphs and ``size.json``
    (pipeline.py:180; reference dataset.py:178-224)."""
    process_raw_dir(cfg.dataset_processed_prefix,
                    skip_exist=bool(cfg.skip_exist))
    LPDataset(cfg.dataset_processed_prefix).size_info(
        recache=not cfg.skip_exist)


def stage_prep_data(cfg: Config, family: str | None = None,
                    n_instances: int = 0, **kwargs) -> None:
    """run_prep_data.py: [generate] -> solve -> raw blobs -> processed
    (pipeline.py:187)."""
    if n_instances:
        stage_generate(cfg, family, n_instances, **kwargs)
    stage_run_solver(cfg)
    stage_cvt_to_pkl(cfg)
    stage_process(cfg)
