"""The port's native C++ simplex engine against the JAX package's, on the
CPU.

The port builds its own copy of ``tpulp.cc`` with g++ and the Makefile's
flags into ``lp_gnn_tpu_torch/_build/``; the JAX package's library is
built by its own Makefile, in a copy of its ``solver/native/`` directory
(so that no other test's in-tree build races this one) and loaded in
place of the in-tree one for this module. The same source with the same
flags on one machine pivots alike: equal statuses, iteration counts and
bases, objectives to 1e-12 relative, on every generator family and for
both methods, and in the warm, repair, crash, devex, BFRT and long
Forrest–Tomlin cases. Logs equal but for their timed values, the
rejected-basis sentinel, the profiling dump and driver, the host SpMM,
the engine's selection (``--engine native|auto``, a broken compiler, the
solver processes' imports), and the prep and report with
``engine="native"`` on both sides.
"""
import contextlib
import dataclasses
import glob
import math
import os
import os.path as osp
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX side runs on the CPU)

from lp_gnn_tpu import pipeline as jpipeline
from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.data.generator import generate_instance as jax_generate
from lp_gnn_tpu.ops import host_spmm as jax_host_spmm
from lp_gnn_tpu.reporting.extract import extract_time as jax_extract_time
from lp_gnn_tpu.solver import native as jnative
from lp_gnn_tpu.solver.crash import bixby_crash_basis as jax_crash
from lp_gnn_tpu.solver.highs_bridge import solve_lp as jax_solve_lp
from lp_gnn_tpu.train.trainer import run_exp as jax_run_exp
from lp_gnn_tpu.utils.serialize import json_load as jax_json_load
from lp_gnn_tpu_torch import pipeline, prep
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.data.generator import GENERATORS, generate_instance
from lp_gnn_tpu_torch.io.bas import write_bas_highs
from lp_gnn_tpu_torch.io.mps import LPData, write_mps
from lp_gnn_tpu_torch.ops import host_spmm
from lp_gnn_tpu_torch.ops.spmm import spmm_csr
from lp_gnn_tpu_torch.reporting.extract import extract_time
from lp_gnn_tpu_torch.solver import _cxx_build, native
from lp_gnn_tpu_torch.solver.crash import bixby_crash_basis
from lp_gnn_tpu_torch.solver.highs_bridge import HAVE_HIGHS, solve_lp
from lp_gnn_tpu_torch.utils.serialize import json_load
from tests.test_torch_isolation import run_isolated
from tests.test_torch_pipeline import _cfgs, cwd

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not HAVE_HIGHS, reason="no vendored highspy")

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_NATIVE = osp.join(ROOT, "lp_gnn_tpu", "solver", "native")
TINY = dict(family="mirp_like", n_instances=10, n_ports=4, n_periods=6)
RTOL = 1e-12
TIMED = ("run time", "time elapsed for factorize")


@contextlib.contextmanager
def jax_native_in(d):
    """The JAX package's library and ``prof_main``, built by its Makefile
    in ``d`` (a copy of its native/ directory, so that no other test's
    in-tree build races this one) and loaded in place of the in-tree
    library inside the context."""
    for f in ("Makefile", "tpulp.cc", "prof_main.cc"):
        shutil.copy(osp.join(JAX_NATIVE, f), d / f)
    subprocess.run(["make", "-C", str(d), "libtpulp.so", "prof_main"],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(d / "libtpulp.so"))
        for mod in (jnative, jax_host_spmm):
            mp.setattr(mod, "_lib", None)
        mp.setattr(jnative, "_cdll", None)
        assert jnative.available()
        yield d


@pytest.fixture(scope="module", autouse=True)
def libs(tmp_path_factory):
    """The port's library (built into ``_build/``) and the JAX package's."""
    native.build()
    assert native.available()
    with jax_native_in(tmp_path_factory.mktemp("jax_native")) as d:
        yield d


def assert_same_solve(r, j, rtol=RTOL):
    """The port's NativeResult equals the JAX one: status, iterations,
    repairs, bases exactly, the objective to ``rtol``."""
    assert (r.status, r.niter, r.n_repair) == (j.status, j.niter, j.n_repair)
    np.testing.assert_array_equal(r.col_status, j.col_status)
    np.testing.assert_array_equal(r.row_status, j.row_status)
    np.testing.assert_allclose(r.objective, j.objective, rtol=rtol, atol=0)


def both(family, **kw):
    """The instance from each package's generator (the same LP)."""
    return (generate_instance(family, **kw), jax_generate(family, **kw))


def _strip_timed(text: str) -> list[str]:
    return [ln for ln in text.split("\n") if not any(t in ln for t in TIMED)]


# ------------------------------------------------------------ engine parity
@pytest.mark.parametrize("family", sorted(GENERATORS))
@pytest.mark.parametrize("method", [1, 4])
def test_engine_parity(family, method):
    """Every generator family, dual and primal: the JAX engine's pivots."""
    lp, jlp = both(family, seed=1, instance=0)
    r = native.solve_lp_native(lp, method=method)
    j = jnative.solve_lp_native(jlp, method=method)
    assert r.status == "Optimal"
    assert_same_solve(r, j)
    nb = (r.col_status == 1).sum() + (r.row_status == 1).sum()
    assert nb == lp.shape[0]
    assert _strip_timed(r.log) == _strip_timed(j.log)


def test_warm_start_zero_iters():
    lp, jlp = both("mirp_like", seed=0, instance=0)
    cold = native.solve_lp_native(lp, method=1)
    warm = native.solve_lp_native(
        lp, method=1, basis_in=(cold.col_status, cold.row_status))
    jcold = jnative.solve_lp_native(jlp, method=1)
    jwarm = jnative.solve_lp_native(
        jlp, method=1, basis_in=(jcold.col_status, jcold.row_status))
    assert warm.status == "Optimal" and warm.niter == 0
    assert_same_solve(warm, jwarm)


def test_repair_counted():
    """Four basics struck from the optimal basis: the same repairs, the
    'Rank_deficiency N' line, the same solve."""
    lp, jlp = both("transport", seed=0, instance=0)
    cold = native.solve_lp_native(lp, method=1)
    colb = cold.col_status.copy()
    colb[np.nonzero(colb == 1)[0][:4]] = 0
    rep = native.solve_lp_native(lp, method=1,
                                 basis_in=(colb, cold.row_status))
    jrep = jnative.solve_lp_native(jlp, method=1,
                                   basis_in=(colb, cold.row_status))
    assert rep.status == "Optimal" and rep.n_repair >= 4
    assert f"Rank_deficiency {rep.n_repair}" in rep.log
    assert_same_solve(rep, jrep)


def test_crash_basis():
    lp, jlp = both("mirp_like", seed=0, instance=1)
    cb, jcb = bixby_crash_basis(lp), jax_crash(jlp)
    for a, b in zip(cb, jcb):
        np.testing.assert_array_equal(a, b)
    ca = native.solve_lp_native(lp, method=1, basis_in=cb)
    assert ca.status == "Optimal"
    assert_same_solve(ca, jnative.solve_lp_native(jlp, method=1, basis_in=jcb))


def _one_var_lp(mod, c, b_l, b_u, lb, ub):
    from scipy.sparse import csr_matrix
    return mod(c=np.array([c]), b_l=np.array([b_l]),
               A=csr_matrix(np.array([[1.0]])), b_u=np.array([b_u]),
               lb=np.array([lb]), ub=np.array([ub]),
               con_nms=np.array(["r0"], dtype=object),
               var_nms=np.array(["x0"], dtype=object))


@pytest.mark.parametrize("case,want", [
    ((1.0, 2.0, np.inf, 0.0, 1.0), "Infeasible"),     # x >= 2, x <= 1
    ((-1.0, 0.0, np.inf, 0.0, np.inf), "Unbounded"),  # min -x, x >= 0
])
def test_infeasible_and_unbounded(case, want):
    from lp_gnn_tpu.io.mps import LPData as JaxLPData
    r = native.solve_lp_native(_one_var_lp(LPData, *case), method=4)
    j = jnative.solve_lp_native(_one_var_lp(JaxLPData, *case), method=4)
    assert r.status == want
    assert (r.status, r.niter) == (j.status, j.niter)


def test_dual_artificial_bounds():
    """A dual warm start with a dual-infeasible column unbounded above: the
    artificial-bound phase 1 and the primal cleanup."""
    from lp_gnn_tpu.io.mps import LPData as JaxLPData
    case = (-1.0, -np.inf, 5.0, 0.0, np.inf)   # min -x, x <= 5, x >= 0
    basis = (np.array([0]), np.array([1]))      # all slacks: d = -1 < 0
    r = native.solve_lp_native(_one_var_lp(LPData, *case), method=1,
                               basis_in=basis)
    j = jnative.solve_lp_native(_one_var_lp(JaxLPData, *case), method=1,
                                basis_in=basis)
    assert r.status == "Optimal" and np.isclose(r.objective, -5.0)
    assert_same_solve(r, j)


def test_bfrt_boxed_heavy():
    """packing (every variable in [0, 1]): the bound-flipping ratio test,
    cold and from a basis with 10% of its basics struck."""
    lp, jlp = both("packing", seed=2, instance=0, m=60, n=120)
    cold = native.solve_lp_native(lp, method=1)
    assert_same_solve(cold, jnative.solve_lp_native(jlp, method=1))
    np.testing.assert_allclose(cold.objective,
                               solve_lp(lp, method=1).objective, rtol=1e-7)
    colb = cold.col_status.copy()
    basic = np.nonzero(colb == 1)[0]
    colb[basic[: max(len(basic) // 10, 1)]] = 0
    warm = native.solve_lp_native(lp, method=1,
                                  basis_in=(colb, cold.row_status))
    assert warm.status == "Optimal"
    assert_same_solve(warm, jnative.solve_lp_native(
        jlp, method=1, basis_in=(colb, cold.row_status)))


def test_long_forrest_tomlin_solve():
    """Many update/refresh cycles (niter >> the refresh interval of 200):
    the JAX engine's iteration count and objective, HiGHS's optimum, and a
    free warm restart from the FT-built basis."""
    kw = dict(seed=1, instance=0, n_ports=15, n_periods=30, arc_density=0.4)
    lp, jlp = both("mirp_like", **kw)
    res = native.solve_lp_native(lp, method=1)
    assert res.status == "Optimal" and res.niter > 1200
    assert_same_solve(res, jnative.solve_lp_native(jlp, method=1))
    np.testing.assert_allclose(res.objective, solve_lp(lp, method=1).objective,
                               rtol=1e-9)
    warm = native.solve_lp_native(
        lp, method=1, basis_in=(res.col_status, res.row_status))
    assert warm.niter <= 2
    assert_same_solve(warm, jnative.solve_lp_native(
        jlp, method=1, basis_in=(res.col_status, res.row_status)))


def test_devex_pricing(monkeypatch):
    """TPULP_PRICING=devex (read at each solve) gives JAX's devex run; the
    default dual steepest edge prices netflow in no more iterations."""
    lp, jlp = both("netflow", seed=3, instance=0)
    monkeypatch.setenv("TPULP_PRICING", "devex")
    rdx = native.solve_lp_native(lp, method=1)
    assert_same_solve(rdx, jnative.solve_lp_native(jlp, method=1))
    monkeypatch.delenv("TPULP_PRICING")
    rse = native.solve_lp_native(lp, method=1)
    assert_same_solve(rse, jnative.solve_lp_native(jlp, method=1))
    assert rse.niter <= rdx.niter
    np.testing.assert_allclose(rse.objective, rdx.objective, rtol=1e-6)


# ------------------------------------------------------------ files and logs
def test_solve_mps_logs_and_bases(tmp_path):
    """Through files: the same ``.bas`` and the same log but for the timed
    values, the reference parsers read it, and a warm start from the
    written basis takes no iteration."""
    from lp_gnn_tpu_torch.reporting.extract import extract_fact_time
    lp = generate_instance("netflow", seed=0, instance=0)
    mps = str(tmp_path / "a.mps")
    write_mps(lp, mps)
    res = native.solve_mps(mps, method=1, basis_out_path=str(tmp_path / "p.bas"),
                           log_path=str(tmp_path / "p.log"))
    jres = jnative.solve_mps(mps, method=1,
                             basis_out_path=str(tmp_path / "j.bas"),
                             log_path=str(tmp_path / "j.log"))
    assert res.status == "Optimal" and not res.basis_rejected
    assert (tmp_path / "p.bas").read_bytes() == (tmp_path / "j.bas").read_bytes()
    plog, jlog = (tmp_path / "p.log").read_text(), (tmp_path / "j.log").read_text()
    assert _strip_timed(plog) == _strip_timed(jlog)
    assert [ln.split(":")[0] for ln in plog.split("\n")] == \
        [ln.split(":")[0] for ln in jlog.split("\n")]
    iters, tm = extract_time(str(tmp_path / "p.log"))
    assert iters == res.niter == jax_extract_time(str(tmp_path / "j.log"))[0]
    assert tm is not None and tm >= 0
    assert extract_fact_time(str(tmp_path / "p.log")) >= 0
    assert native.solve_mps(mps, method=1,
                            basis_in_path=str(tmp_path / "p.bas")).niter == 0


@pytest.mark.parametrize("bad", ["wrong_size", "unreadable"])
def test_rejected_basis_sentinel(tmp_path, bad):
    """A basis of the wrong size or an unreadable one: the solve runs cold,
    the log parses to (-1, -1) as JAX's does, and ``basis_rejected`` is
    set (the port's warm gate then scores -1)."""
    lp = generate_instance("netflow", seed=0, instance=0)
    mps = str(tmp_path / "a.mps")
    write_mps(lp, mps)
    path = str(tmp_path / "bad.bas")
    if bad == "wrong_size":
        write_bas_highs(path, vbas=np.zeros(3, np.int64),
                        cbas=np.ones(2, np.int64))
    else:
        with open(path, "w") as f:
            f.write("not a basis\n")
    res = native.solve_mps(mps, method=1, basis_in_path=path,
                           log_path=str(tmp_path / "p.log"))
    jnative.solve_mps(mps, method=1, basis_in_path=path,
                      log_path=str(tmp_path / "j.log"))
    assert res.basis_rejected and res.status == "Optimal"
    assert extract_time(str(tmp_path / "p.log")) == (-1, -1) == \
        jax_extract_time(str(tmp_path / "j.log"))
    assert _strip_timed((tmp_path / "p.log").read_text()) == \
        _strip_timed((tmp_path / "j.log").read_text())


def test_dump_and_prof_main(tmp_path, libs):
    """``dump_lp_bin`` writes JAX's bytes, and the port's ``prof_main``
    (built by ``_cxx_build``) reads it and gives the ctypes solve's
    iterations and objective, as the JAX package's driver does."""
    lp, jlp = both("transport", seed=3, instance=0)
    ref = native.solve_lp_native(lp, method=1)
    native.dump_lp_bin(lp, str(tmp_path / "p.bin"))
    jnative.dump_lp_bin(jlp, str(tmp_path / "j.bin"))
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    outs = []
    for exe in (_cxx_build.build("prof_main"), libs / "prof_main"):
        outs.append(subprocess.run([str(exe), str(tmp_path / "p.bin")],
                                   check=True, capture_output=True,
                                   text=True).stdout)
    assert outs[0] == outs[1]
    assert "rc=0" in outs[0] and f"niter={ref.niter}" in outs[0]
    obj = float(outs[0].split("obj=")[1].split()[0])
    # prof_main reports the raw objective (no obj_const)
    np.testing.assert_allclose(obj + lp.obj_const, ref.objective, rtol=1e-6,
                               atol=1e-6)


def test_highs_solution_vectors():
    """``solve_lp(want_solution=True)``: the JAX bridge's primal values
    and reduced costs (the same HiGHS); without the flag they are None."""
    lp, jlp = both("mirp_like", seed=0, instance=2)
    r = solve_lp(lp, method=1, want_solution=True)
    j = jax_solve_lp(jlp, method=1, want_solution=True)
    n = lp.shape[1]
    for k, size in (("col_value", n), ("col_dual", n)):
        assert getattr(r, k).shape == (size,)
        np.testing.assert_array_equal(getattr(r, k), getattr(j, k))
    assert solve_lp(lp, method=1).col_value is None


# ------------------------------------------------------------ host SpMM
def test_host_spmm_matches_jax_and_plain():
    rng = np.random.RandomState(5)
    e, n_dst, n_src, d = 400, 37, 53, 6
    dst = np.sort(rng.randint(0, n_dst, e))
    src = rng.randint(0, n_src, e)
    val = rng.randn(e)
    x = rng.randn(n_src, d)
    got = host_spmm.spmm_host(dst, src, val, x, num_dst=n_dst)
    np.testing.assert_allclose(
        got, jax_host_spmm.spmm_host(dst, src, val, x, num_dst=n_dst),
        rtol=RTOL, atol=1e-12)
    ptr = np.zeros(n_dst + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=n_dst), out=ptr[1:])
    plain = spmm_csr(torch.from_numpy(ptr),
                     torch.from_numpy(src.astype(np.int32)),
                     torch.from_numpy(val.astype(np.float32)),
                     torch.from_numpy(x.astype(np.float32)))
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-6, atol=1e-6)
    gout = rng.randn(n_dst, d)
    gval = host_spmm.sddmm_host(dst, src, gout, x)
    np.testing.assert_allclose(
        gval, jax_host_spmm.sddmm_host(dst, src, gout, x), rtol=RTOL,
        atol=1e-12)
    np.testing.assert_allclose(gval, (gout[dst] * x[src]).sum(1), rtol=1e-12,
                               atol=1e-12)


def test_host_spmm_rejects_out_of_range_indices():
    """The C++ SpMM writes through raw pointers: indices a device segment
    sum would drop are refused before the call."""
    assert host_spmm.available()
    x = np.ones((4, 2))
    with pytest.raises(ValueError, match="dst out of range"):
        host_spmm.spmm_host(np.array([0, 3]), np.array([0, 1]), np.ones(2), x,
                            num_dst=3)
    with pytest.raises(ValueError, match="src out of range"):
        host_spmm.sddmm_host(np.array([0, 1]), np.array([0, 4]),
                             np.ones((2, 2)), x)
    with pytest.raises(ValueError, match="src out of range"):
        host_spmm.spmm_host(np.array([0, 1]), np.array([-1, 1]), np.ones(2),
                            x, num_dst=3)


# ------------------------------------------------------------ selection
def _tiny_dataset(root) -> Config:
    cfg = Config(dataset="nf", data_prefix=str(root / "lp-dataset"),
                 device="cpu").finalize(make_log_dir=False)
    prep.stage_generate(cfg, "netflow", 2, n_nodes=15, density=0.25)
    return cfg


def test_engine_native_builds_and_runs(tmp_path):
    cfg = dataclasses.replace(_tiny_dataset(tmp_path), engine="native")
    assert prep.solve_backend(cfg) is native.solve_mps
    prep.stage_run_solver(cfg)
    for log in glob.glob(f"{cfg.dataset_prefix}/log/highs-no-bas/*.log"):
        with open(log) as f:
            text = f.read()
        assert "Rank_deficiency 0" in text and "tpulp native" in text
        assert extract_time(log)[0] >= 0


def test_engine_auto_follows_the_build(tmp_path, monkeypatch):
    """``auto``: HiGHS while ``_build/`` holds no library, native once one
    is built there (the build pointed at an empty directory)."""
    from lp_gnn_tpu_torch.solver import highs_bridge
    monkeypatch.setattr(_cxx_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_cdll", None)
    monkeypatch.setattr(native, "_lib", None)
    cfg = Config(engine="auto")
    assert not native.available()
    assert prep.solve_backend(cfg) is highs_bridge.solve_mps
    path = native.build()
    assert osp.dirname(path) == str(tmp_path / "build")
    assert prep.solve_backend(cfg) is native.solve_mps


def test_engine_native_broken_compiler_raises(tmp_path, monkeypatch):
    """``CXX=false``: the build fails, ``--engine native`` raises with the
    compiler's exit, and no solver (HiGHS least of all) runs."""
    cfg = dataclasses.replace(_tiny_dataset(tmp_path), engine="native")
    monkeypatch.setattr(_cxx_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_cdll", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        prep.stage_run_solver(cfg)
    assert not osp.exists(f"{cfg.dataset_prefix}/log")
    assert not osp.exists(f"{cfg.dataset_prefix}/highs-basis")
    assert os.listdir(tmp_path / "build") == []   # no temporary file left


def test_solver_processes_import_no_torch(tmp_path):
    """What a prep solver process runs (``solve_one_cold`` with the native
    engine, a spawned pool over it) in a process where torch does not
    import."""
    cfg = _tiny_dataset(tmp_path)
    run_isolated(f"""
        # at module level: the spawned pool's processes run it too
        for m in ("torch", "torch.distributed"):
            sys.modules[m] = None
        import glob
        from lp_gnn_tpu_torch import prep
        from lp_gnn_tpu_torch.config import Config
        from lp_gnn_tpu_torch.solver import native

        if __name__ == "__main__":
            assert native.available()
            cfg = Config(dataset="nf", data_prefix={cfg.data_prefix!r},
                         engine="native", num_workers=2).finalize(
                             make_log_dir=False)
            prep.solve_one_cold(prep.mps_files(cfg)[0], cfg)
            prep.stage_run_solver(cfg)
            logs = glob.glob(cfg.dataset_prefix + "/log/highs-no-bas/*.log")
            assert len(logs) == 2, logs
            assert all("Rank_deficiency" in open(p).read() for p in logs)
            assert not [m for m, v in sys.modules.items()
                        if v is not None and m.split(".")[0] == "torch"]
    """, tmp_path)


# ------------------------------------------------------------ the pipeline
def prep_both_native(root, dataset: str, **kwargs):
    for side in ("jax", "port"):
        d = osp.join(root, side)
        os.makedirs(d, exist_ok=True)
        with cwd(d):
            if side == "jax":
                cfg = JaxConfig(dataset=dataset, seed=0, engine="native"
                                ).finalize(make_log_dir=False)
                jpipeline.stage_prep_data(cfg, **kwargs)
            else:
                cfg = Config(dataset=dataset, seed=0, engine="native",
                             device="cpu").finalize(make_log_dir=False)
                prep.stage_prep_data(cfg, **kwargs)


@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_native_pipeline"))
    prep_both_native(root, "mirp_like", **TINY)
    return root


def test_prep_native_byte_identical(prepped):
    """With ``engine="native"`` on both sides: every file equal, byte for
    byte, the logs but for "run time" and "time elapsed for factorize"."""
    a = osp.join(prepped, "jax", "lp-dataset", "mirp_like")
    b = osp.join(prepped, "port", "lp-dataset", "mirp_like")
    files = sorted(osp.relpath(p, a) for p in glob.glob(f"{a}/**/*",
                                                        recursive=True)
                   if osp.isfile(p))
    assert files == sorted(osp.relpath(p, b) for p in glob.glob(
        f"{b}/**/*", recursive=True) if osp.isfile(p))
    assert len(files) == 81
    for rel in files:
        with open(osp.join(a, rel), "rb") as fa, \
                open(osp.join(b, rel), "rb") as fb:
            ba, bb = fa.read(), fb.read()
        if rel.endswith(".log"):
            assert _strip_timed(ba.decode()) == _strip_timed(bb.decode()), rel
            assert "Rank_deficiency" in bb.decode(), rel
        else:
            assert ba == bb, rel
    for log in glob.glob(f"{b}/log/highs-no-bas/*.log"):
        assert extract_time(log)[0] >= 0


@pytest.fixture(scope="module")
def reported(prepped):
    """Both packages, ``engine="native"``: predict -> gate -> warm start ->
    val -> extract from one JAX checkpoint."""
    cfg = JaxConfig(exp_nm="train", dataset="mirp_like",
                    arch="GCN_FC(8,8,hids=32,depth=3)", epochs=8,
                    data_prefix=osp.join(prepped, "jax", "lp-dataset"),
                    log_prefix=osp.join(prepped, "jax", "runs"),
                    seed=0).finalize()
    ckpt = jax_run_exp(cfg)
    jcfg, tcfg = _cfgs(prepped, "native", ckpt, engine="native")
    jpipeline.stage_pred_basis(jcfg, ckpt)
    jpipeline.stage_warm_start(jcfg)
    jpipeline.stage_val(jcfg, ckpt, wrt_converged=True)
    jdf, _ = jpipeline.stage_extract(jcfg)
    pipeline.stage_pred_basis(tcfg, ckpt)
    pipeline.stage_warm_start(tcfg)
    pipeline.stage_val(tcfg, ckpt, wrt_converged=True)
    rows, summary = pipeline.stage_extract(tcfg)
    return jcfg, tcfg, jdf, rows


def test_native_bases_gate_and_warm_iterations(reported):
    jcfg, tcfg, *_ = reported
    for folder in ("pred-basis", "warm-gate-calib", "opt-from-pred-basis"):
        names = sorted(os.listdir(osp.join(tcfg.log_dir, folder)))
        assert names == sorted(os.listdir(osp.join(jcfg.log_dir, folder)))
        for f in (x for x in names if x.endswith(".bas")):
            with open(osp.join(jcfg.log_dir, folder, f), "rb") as a, \
                    open(osp.join(tcfg.log_dir, folder, f), "rb") as b:
                assert a.read() == b.read(), (folder, f)
    jg = jax_json_load(osp.join(jcfg.log_dir, "warm_gate.json"))
    tg = json_load(osp.join(tcfg.log_dir, "warm_gate.json"))
    for key in ("proceed", "k", "failures", "decode"):
        assert tg[key] == jg[key], key
    assert [(lp["fn"], lp["warm_niter"]) for lp in tg["lps"]] == \
        [(lp["fn"], lp["warm_niter"]) for lp in jg["lps"]]
    for sub in ("gnn-bas-0", "warm-gate-calib", "highs-no-bas"):
        logs = sorted(os.listdir(osp.join(tcfg.log_dir, "log", sub)))
        assert logs == sorted(os.listdir(osp.join(jcfg.log_dir, "log", sub)))
        for f in logs:
            with open(osp.join(tcfg.log_dir, "log", sub, f)) as fh:
                text = fh.read()
            assert "Rank_deficiency" in text
            assert "time elapsed for factorize:" in text
            got = extract_time(osp.join(tcfg.log_dir, "log", sub, f))[0]
            assert got == jax_extract_time(
                osp.join(jcfg.log_dir, "log", sub, f))[0] >= 0, (sub, f)
    assert len(os.listdir(osp.join(tcfg.log_dir, "log", "gnn-bas-0"))) == 3


def test_native_results_table_equal(reported):
    """The JAX time.h5's numbers in the port's time.json, the repair
    columns included (``repair_p``, ``repair_p2``); timed cells
    (``*time*``, ``fact_time`` among them) are measurements, only present."""
    jcfg, tcfg, jdf, rows = reported
    cols = [c for c in jdf.columns if "time" not in c]
    assert {k for r in rows for k in r if "time" not in k} == set(cols)
    jdf = jdf.set_index("fn")
    for r in rows:
        for c in cols:
            if c == "fn":
                continue
            want, got = jdf.loc[r["fn"], c], r.get(c)
            if isinstance(want, str):
                assert got == want, (r["fn"], c)
            elif "/niter" in c:
                assert (math.isnan(want) and got is None) or got == want, \
                    (r["fn"], c)
            else:
                np.testing.assert_allclose(
                    math.nan if got is None else float(got), float(want),
                    rtol=RTOL, err_msg=f"{r['fn']} {c}")
    val = [r for r in rows if r["split"] == "val"]
    assert len(val) == 3
    for r in val:
        for c in ("gnn-bas-0/repair_p", "gnn-bas-0/repair_p2",
                  "gnn-bas-0/fact_time"):
            assert r.get(c) is not None and r[c] >= 0, (r["fn"], c)
