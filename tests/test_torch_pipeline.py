"""The port's whole pipeline against the JAX package's, on the CPU.

Data prep: both packages prep the same tiny family from one seed, each in
its own directory under the same relative data prefix (the ``.meta``
sidecars name their paths): MPS files, cold and crash ``.bas`` files, raw
and processed blobs and ``size.json`` byte-identical, logs identical but
for the "run time" line. Every generator family and ``-perm`` has a case.

Train and report: both packages predict, calibrate the warm gate, warm
start, validate and extract from ONE JAX ``mdl.ckpt``: equal ``.bas``
files, equal gate decisions and per-LP payback, equal warm iteration
counts, equal results-table numbers (iterations exact, ratios and metrics
to 1e-12 relative). Also: the gate declines an all-slacks decode, the
primal method runs, the port's reporting runs where pandas does not import.
"""
import contextlib
import dataclasses
import glob
import math
import os
import os.path as osp
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX side runs on the CPU)

from lp_gnn_tpu import pipeline as jpipeline
from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.reporting.extract import extract_time as jax_extract_time
from lp_gnn_tpu.train.trainer import run_exp as jax_run_exp
from lp_gnn_tpu.utils.serialize import json_load as jax_json_load
from lp_gnn_tpu_torch import pipeline, prep
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.data.generator import GENERATORS, SIZES
from lp_gnn_tpu_torch.reporting.extract import extract_time, summarize
from lp_gnn_tpu_torch.solver.highs_bridge import HAVE_HIGHS
from lp_gnn_tpu_torch.utils.misc import split_out_chunk
from lp_gnn_tpu_torch.utils.serialize import json_load

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not HAVE_HIGHS, reason="no vendored highspy")

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
ARCH = "GCN_FC(8,8,hids=32,depth=3)"
TINY = dict(family="mirp_like", n_instances=10, n_ports=4, n_periods=6)
RTOL = 1e-12


@contextlib.contextmanager
def cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def prep_both(root, dataset: str, **kwargs):
    """Prep ``dataset`` with each package under ``root/{jax,port}`` at the
    relative data prefix ``lp-dataset``."""
    for side in ("jax", "port"):
        d = osp.join(root, side)
        os.makedirs(d, exist_ok=True)
        with cwd(d):
            if side == "jax":
                cfg = JaxConfig(dataset=dataset, seed=0).finalize(
                    make_log_dir=False)
                jpipeline.stage_prep_data(cfg, **kwargs)
            else:
                cfg = Config(dataset=dataset, seed=0, device="cpu").finalize(
                    make_log_dir=False)
                prep.stage_prep_data(cfg, **kwargs)


def _strip_run_time(text: str) -> list[str]:
    return [ln for ln in text.split("\n") if "run time" not in ln]


def assert_trees_identical(a: str, b: str) -> int:
    """Every file under ``a`` and ``b`` (the same set of paths) is equal:
    byte for byte, logs but for their "run time" line. Returns the count."""
    files_a = sorted(osp.relpath(p, a) for p in glob.glob(f"{a}/**/*",
                                                         recursive=True)
                     if osp.isfile(p))
    files_b = sorted(osp.relpath(p, b) for p in glob.glob(f"{b}/**/*",
                                                         recursive=True)
                     if osp.isfile(p))
    assert files_a == files_b
    for rel in files_a:
        with open(osp.join(a, rel), "rb") as fa, open(osp.join(b, rel), "rb") as fb:
            ba, bb = fa.read(), fb.read()
        if rel.endswith(".log"):
            assert _strip_run_time(ba.decode()) == _strip_run_time(bb.decode()), rel
        else:
            assert ba == bb, rel
    return len(files_a)


# ------------------------------------------------------------------ prep
@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_pipeline"))
    prep_both(root, "mirp_like", **TINY)
    return root


def test_prep_byte_identical(prepped):
    """MPS, cold .bas, crash .bas, logs, raw and processed blobs with their
    .meta, size.json: the port's prep is the JAX package's."""
    ds = "lp-dataset/mirp_like"
    n = assert_trees_identical(osp.join(prepped, "jax", ds),
                               osp.join(prepped, "port", ds))
    port = osp.join(prepped, "port", ds)
    for sub, k in (("mps", 10), ("highs-basis", 10), ("log/highs-no-bas", 10),
                   ("log/highs-ca-bas-m1", 10), ("highs-inp_tgt/raw", 10),
                   ("highs-inp_tgt/processed", 20)):
        assert len(os.listdir(osp.join(port, sub))) == k, sub
    assert osp.exists(osp.join(port, "highs-inp_tgt", "size.json"))
    assert n == 81
    for log in glob.glob(f"{port}/log/highs-no-bas/*.log"):
        assert extract_time(log)[0] >= 0   # every cold solve Optimal


def _family_cases():
    cases = []
    for fam in GENERATORS:
        kw = dict(SIZES.get(fam, {}).get("small", {}))
        if fam == "mirp_mix_s":   # no small tier: a small network
            kw = dict(n_ports=4, n_periods_range=(4, 8))
        cases.append((fam, fam, kw))
    cases.append(("mirp_like-perm", "mirp_like", SIZES["mirp_like"]["small"]))
    return cases


@pytest.mark.parametrize("dataset,family,kwargs", _family_cases(),
                         ids=[c[0] for c in _family_cases()])
def test_prep_family_parity(tmp_path, dataset, family, kwargs):
    """Each generator family (and ``-perm``, the per-instance relabeling)
    preps to the JAX package's bytes: generate, solve, label, process."""
    prep_both(str(tmp_path), dataset, family=family, n_instances=3, **kwargs)
    n = assert_trees_identical(
        str(tmp_path / "jax" / "lp-dataset" / dataset),
        str(tmp_path / "port" / "lp-dataset" / dataset))
    assert n >= 3 * 6
    if dataset.endswith("-perm"):
        with open(tmp_path / "port" / "lp-dataset" / dataset / "mps"
                  / "mirp_like_0.mps") as f:
            assert "mirp_like-perm" in f.readline()


def test_prep_workers_and_skip_exist(prepped, tmp_path):
    """``--num_workers 2`` (a spawned pool) writes the same bytes as the
    serial run; a ``--skip_exist 1`` rerun rewrites nothing."""
    d = tmp_path / "port"
    shutil.copytree(osp.join(prepped, "port", "lp-dataset", "mirp_like", "mps"),
                    d / "lp-dataset" / "mirp_like" / "mps")
    with cwd(d):
        cfg = Config(dataset="mirp_like", seed=0, num_workers=2,
                     device="cpu").finalize(make_log_dir=False)
        prep.stage_prep_data(cfg)
    assert_trees_identical(osp.join(prepped, "port", "lp-dataset", "mirp_like"),
                           str(d / "lp-dataset" / "mirp_like"))
    cfg = Config(dataset="mirp_like", data_prefix=str(d / "lp-dataset"),
                 skip_exist=1, device="cpu").finalize(make_log_dir=False)
    stamps = {p: os.stat(p).st_mtime_ns
              for p in glob.glob(f"{cfg.dataset_prefix}/**/*", recursive=True)
              if osp.isfile(p)}
    prep.stage_run_solver(cfg)
    prep.stage_cvt_to_pkl(cfg)
    prep.stage_process(cfg)
    for p, t in stamps.items():
        assert os.stat(p).st_mtime_ns == t, f"rewritten: {p}"


def test_prep_errors_and_chunks(tmp_path, monkeypatch):
    cfg = Config(dataset="nope", data_prefix=str(tmp_path),
                 device="cpu").finalize(make_log_dir=False)
    with pytest.raises(ValueError, match="no mps under"):
        prep.stage_run_solver(cfg)
    with pytest.raises(ValueError, match="one of"):
        prep.solve_backend(dataclasses.replace(cfg, engine="cplex"))
    from lp_gnn_tpu_torch.solver import _cxx_build, native
    # native builds the engine (tests/test_torch_native.py holds it to
    # JAX's); auto then takes it, as it takes HiGHS without a build there.
    # The build goes to a directory of its own, so that the checkout's
    # _build/ (which auto reads) stays as it was.
    monkeypatch.setattr(_cxx_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_cdll", None)
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    assert prep.solve_backend(dataclasses.replace(cfg, engine="native")) \
        is native.solve_mps
    auto = prep.solve_backend(dataclasses.replace(cfg, engine="auto"))
    assert auto is native.solve_mps
    assert prep.solve_backend(cfg) is not native.solve_mps   # highs
    fns = [f"f{i}" for i in range(10)]
    assert split_out_chunk(fns, None) == fns
    assert split_out_chunk(fns, "0/3") + split_out_chunk(fns, "1/3") + \
        split_out_chunk(fns, "2/3") == fns


# ------------------------------------------------------- train and report
@pytest.fixture(scope="module")
def jax_ckpt(prepped):
    """A JAX mdl.ckpt trained on the JAX side's copy of the family."""
    cfg = JaxConfig(exp_nm="train", dataset="mirp_like", arch=ARCH, epochs=12,
                    data_prefix=osp.join(prepped, "jax", "lp-dataset"),
                    log_prefix=osp.join(prepped, "jax", "runs"),
                    seed=0).finalize()
    return jax_run_exp(cfg)


def _cfgs(prepped, exp_nm, ckpt, **kw):
    jcfg = JaxConfig(exp_nm=exp_nm, dataset="mirp_like", arch=ARCH,
                     data_prefix=osp.join(prepped, "jax", "lp-dataset"),
                     log_prefix=osp.join(prepped, "jax", "runs"),
                     load_from=ckpt, seed=0, **kw).finalize()
    tcfg = Config(exp_nm=exp_nm, dataset="mirp_like", arch=ARCH,
                  data_prefix=osp.join(prepped, "port", "lp-dataset"),
                  log_prefix=osp.join(prepped, "port", "runs"),
                  load_from=ckpt, seed=0, device="cpu", **kw).finalize()
    return jcfg, tcfg


@pytest.fixture(scope="module")
def reported(prepped, jax_ckpt):
    """Both packages' predict -> gate -> warm start -> val -> extract from
    the one checkpoint."""
    jcfg, tcfg = _cfgs(prepped, "parity", jax_ckpt)
    jpipeline.stage_pred_basis(jcfg, jax_ckpt)
    jpipeline.stage_warm_start(jcfg)
    jpipeline.stage_val(jcfg, jax_ckpt, wrt_converged=True)
    jdf, _ = jpipeline.stage_extract(jcfg)
    pipeline.stage_pred_basis(tcfg, jax_ckpt)
    pipeline.stage_warm_start(tcfg)
    pipeline.stage_val(tcfg, jax_ckpt, wrt_converged=True)
    rows, summary = pipeline.stage_extract(tcfg)
    return jcfg, tcfg, jdf, rows, summary


def test_bases_and_warm_gate_equal(reported):
    jcfg, tcfg, *_ = reported
    for folder in ("pred-basis", "warm-gate-calib", "opt-from-pred-basis"):
        jb = sorted(os.listdir(osp.join(jcfg.log_dir, folder)))
        tb = sorted(os.listdir(osp.join(tcfg.log_dir, folder)))
        assert jb == tb and jb, folder
        for f in (x for x in jb if x.endswith(".bas")):
            with open(osp.join(jcfg.log_dir, folder, f)) as a, \
                    open(osp.join(tcfg.log_dir, folder, f)) as b:
                assert a.read() == b.read(), (folder, f)
    jg = jax_json_load(osp.join(jcfg.log_dir, "warm_gate.json"))
    tg = json_load(osp.join(tcfg.log_dir, "warm_gate.json"))
    for key in ("proceed", "k", "k_min", "k_max", "failures", "rule",
                "decode"):
        assert tg[key] == jg[key], key
    assert [(lp["fn"], lp["cold_niter"], lp["warm_niter"]) for lp in tg["lps"]] \
        == [(lp["fn"], lp["cold_niter"], lp["warm_niter"]) for lp in jg["lps"]]
    np.testing.assert_allclose([lp["impr"] for lp in tg["lps"]],
                               [lp["impr"] for lp in jg["lps"]], rtol=RTOL)
    np.testing.assert_allclose([tg["mean_impr"], *tg["ci90"]],
                               [jg["mean_impr"], *jg["ci90"]], rtol=RTOL)
    assert 5 <= tg["k"] <= 12


def test_warm_iterations_equal(reported):
    jcfg, tcfg, *_ = reported
    for sub in ("gnn-bas-0", "warm-gate-calib", "highs-no-bas"):
        logs = sorted(os.listdir(osp.join(tcfg.log_dir, "log", sub)))
        assert logs == sorted(os.listdir(osp.join(jcfg.log_dir, "log", sub)))
        for f in logs:
            got = extract_time(osp.join(tcfg.log_dir, "log", sub, f))[0]
            want = jax_extract_time(osp.join(jcfg.log_dir, "log", sub, f))[0]
            assert got == want >= 0, (sub, f)
    assert len(os.listdir(osp.join(tcfg.log_dir, "log", "gnn-bas-0"))) == 3


def _num(v):
    return math.nan if v is None else float(v)


def test_results_table_equal(reported):
    """The port's time.json holds the JAX time.h5's numbers: iteration
    counts exactly, ratios and metrics to 1e-12 relative, NaN where it has
    NaN. Times (solver, inference) are measurements, not compared."""
    jcfg, tcfg, jdf, rows, summary = reported
    assert rows == json_load(osp.join(tcfg.log_dir, "time.json"))
    cols = [c for c in jdf.columns if "time" not in c]
    port_cols = {k for r in rows for k in r if "time" not in k}
    assert port_cols == set(cols)
    for col in ("highs-no-bas/niter", "gnn-bas-0/niter",
                "gnn-bas-0/impr_niter", "acc", "cvg/acc", "split"):
        assert col in port_cols
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
                np.testing.assert_allclose(_num(got), float(want), rtol=RTOL,
                                           err_msg=f"{r['fn']} {c}")
    val = [r for r in rows if r["split"] == "val"]
    assert len(val) == 3 and all(r["gnn-bas-0/niter"] >= 0 for r in val)
    mean, std = summary["val"]["gnn-bas-0/impr_niter"]
    want = jdf[jdf.split == "val"]["gnn-bas-0/impr_niter"]
    np.testing.assert_allclose([mean, std], [want.mean(), want.std()],
                               rtol=RTOL)


def test_reporting_without_pandas(reported, tmp_path):
    """stage_extract in a process where pandas does not import writes the
    same time.json numbers as the run with pandas, and no time.h5."""
    _, tcfg, *_ = reported
    run = tmp_path / "runs" / "copy"
    shutil.copytree(tcfg.log_dir, run)
    os.remove(run / "time.h5")
    script = tmp_path / "extract.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        for m in ("pandas", "jax", "jaxlib", "optax", "lp_gnn_tpu"):
            sys.modules[m] = None
        sys.path.insert(0, {ROOT!r})
        from lp_gnn_tpu_torch import pipeline
        from lp_gnn_tpu_torch.config import Config
        cfg = Config(exp_nm="copy", dataset="mirp_like",
                     data_prefix={tcfg.data_prefix!r},
                     log_prefix={str(tmp_path / "runs")!r},
                     device="cpu").finalize()
        pipeline.stage_extract(cfg)
    """))
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "gnn-bas-0/impr_niter" in res.stdout
    assert not (run / "time.h5").exists()
    want = json_load(osp.join(tcfg.log_dir, "time.json"))
    got = json_load(str(run / "time.json"))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if "time" not in k:
                assert g[k] == v, k
    with open(run / "summary.tex.csv") as f:
        assert f.readline().strip() == ",train,val"


def test_warm_gate_declines_all_slacks(prepped):
    """--warm_gate auto with the all-slacks decode: no payback on the
    calibration LPs, so the gate declines and the val 'warm' solves run
    cold, with the cold iteration counts (test_pipeline.py:149)."""
    cfg = Config(exp_nm="gate", dataset="mirp_like", arch=ARCH,
                 data_prefix=osp.join(prepped, "port", "lp-dataset"),
                 log_prefix=osp.join(prepped, "port", "runs"),
                 inference_manager="InferenceManager(1, run=2)",
                 load_from="None", warm_gate="auto", device="cpu").finalize()
    pipeline.stage_pred_basis(cfg)
    gate = json_load(osp.join(cfg.log_dir, "warm_gate.json"))
    assert gate["proceed"] is False and gate["k"] > 0
    assert all(lp["impr"] <= 0 for lp in gate["lps"])
    pipeline.stage_warm_start(cfg)
    logs = sorted(glob.glob(f"{cfg.log_dir}/log/all-slacks-bas-2/*.log"))
    assert len(logs) == 3
    for log in logs:
        cold = f"{cfg.dataset_prefix}/log/highs-no-bas/{osp.basename(log)}"
        assert extract_time(log)[0] == extract_time(cold)[0]


def test_primal_method_runs(prepped):
    """--lp_method 4 through prep and run_train_test with the -m4
    suffixes (test_pipeline.py:124)."""
    cfg = Config(exp_nm="m4", dataset="mirp_like", arch=ARCH, epochs=4,
                 lp_method=4,
                 data_prefix=osp.join(prepped, "port", "lp-dataset"),
                 log_prefix=osp.join(prepped, "port", "runs"),
                 device="cpu").finalize()
    assert cfg.dataset_processed_prefix.endswith("-m4")
    prep.stage_prep_data(cfg)
    assert len(os.listdir(f"{cfg.dataset_prefix}/highs-basis-m4")) == 10
    assert len(os.listdir(f"{cfg.dataset_prefix}/log/highs-no-bas-m4")) == 10
    out = pipeline.run_train_test(cfg)
    val = [r for r in out["rows"] if r["split"] == "val"]
    assert all(r["highs-no-bas-m4/niter"] >= 0 for r in val)
    assert all(r["gnn-bas-0-m4/niter"] >= 0 for r in val)
    assert all("gnn-bas-0-m4/impr_niter" in r for r in val)
    assert "gnn-bas-0-m4/impr_niter" in out["summary"]["val"]


def test_summary_matches_pandas():
    """summarize: mean and std (ddof=1) over non-NaN values, sentinels
    -1/-2/-3 left out, per split (pandas' groupby agg)."""
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(3)
    rows = []
    for i in range(9):
        rows.append({"fn": f"lp_{i}", "split": "val" if i % 3 else "train",
                     "acc": float(rng.rand()),
                     "a/niter": int(rng.choice([-1, -2, 5, 9, 40])),
                     "a/impr_niter": None if i == 4 else float(rng.randn())})
    got = summarize(rows)
    df = pd.DataFrame(rows)
    df.loc[df["a/niter"].isin([-1, -2, -3]), "a/niter"] = np.nan
    want = df[["acc", "a/niter", "a/impr_niter", "split"]].groupby(
        "split").agg(["mean", "std"])
    for split in ("train", "val"):
        for c in ("acc", "a/niter", "a/impr_niter"):
            np.testing.assert_allclose(got[split][c],
                                       [want.loc[split, (c, "mean")],
                                        want.loc[split, (c, "std")]],
                                       rtol=RTOL)


def test_t_interval_matches_jax():
    for xs in ([0.69, 0.18, -0.52, 0.71, -0.54], [-0.2, -0.3, -0.25],
               [0.0] * 5, [0.5], list(np.linspace(-1, 1, 40))):
        np.testing.assert_allclose(pipeline._t_interval(xs),
                                   jpipeline._t_interval(xs), rtol=RTOL)


def test_train_cli_run_dir_logs(prepped):
    """The train CLI's run dir holds the reference's logs: ``log-ing``
    (the logging records), ``log-prt`` and ``log-prt-err`` (stdout and
    stderr teed, as tests/test_utils.py:116 tests the JAX tee)."""
    import logging
    from lp_gnn_tpu_torch.train.__main__ import main as train_main
    from lp_gnn_tpu_torch.utils.log import _Tee
    out0, err0 = sys.stdout, sys.stderr
    handlers0 = list(logging.getLogger().handlers)
    try:
        path = train_main([
            "--dataset", "mirp_like", "--exp_nm", "cli-logs", "--arch", ARCH,
            "--data_prefix", osp.join(prepped, "port", "lp-dataset"),
            "--log_prefix", osp.join(prepped, "port", "runs"),
            "--epochs", "1", "--device", "cpu"])
        print("to-stderr", file=sys.stderr)
        sys.stdout.flush(), sys.stderr.flush()
        run = osp.dirname(path)
        with open(osp.join(run, "log-prt")) as f:
            assert path in f.read()
        with open(osp.join(run, "log-prt-err")) as f:
            assert "to-stderr" in f.read()
        for h in logging.getLogger().handlers:
            h.flush()
        with open(osp.join(run, "log-ing")) as f:
            assert "ep 0" in f.read()
    finally:
        for stream in (sys.stdout, sys.stderr):
            if isinstance(stream, _Tee):
                stream.close()
        sys.stdout, sys.stderr = out0, err0
        for h in logging.getLogger().handlers:
            if h not in handlers0:
                logging.getLogger().removeHandler(h)
                h.close()


# ------------------------------------------------------------- file formats
MPS_SAMPLES = {
    "ranges_bounds": """* comment
NAME          TEST
ROWS
 N  COST
 L  LIM1
 G  LIM2
 E  EQ1
 N  FREE
COLUMNS
    MARKER  'MARKER'  'INTORG'
    X1  COST  1.0  LIM1  1.0
    X1  LIM2  1.0
    MARKER  'MARKER'  'INTEND'
    X2  COST  2.0  LIM1  1.0
    X2  EQ1  -1.0
    X3  COST  -1.0  LIM2  1.0  EQ1  1.0
    X4  FREE  1.0
RHS
    RHS  LIM1  4.0  LIM2  1.0
    RHS  EQ1  7.0  COST  1.5
RANGES
    RNG  LIM1  2.5  LIM2  3.0
    RNG  EQ1  -6.0
BOUNDS
 UP BND  X1  4.0
 LO BND  X2  -1.0
 FR BND  X3
 UP BND  X4  -2.0
ENDATA
""",
    "objsense_max": """NAME          T
OBJSENSE
    MAX
ROWS
 N  COST
 L  R1
COLUMNS
    X1  COST  2.0  R1  1.0
    X2  COST  1.0  R1  2.0
RHS
    RHS  R1  10.0
BOUNDS
 MI BND  X1
 FX BND  X2  2.5
 BV BND  X3
ENDATA
""",
}


@pytest.mark.parametrize("name", sorted(MPS_SAMPLES) + ["random", "gz"])
def test_mps_read_write_match_jax(tmp_path, name):
    """read_mps gives the JAX reader's LP (senses, ranges, bounds, MAX, N
    rows, markers, ``.gz``), and write_mps writes the JAX writer's bytes."""
    import gzip
    from scipy.sparse import random as sprandom
    from lp_gnn_tpu.io.mps import read_mps as jax_read_mps
    from lp_gnn_tpu.io.mps import write_mps as jax_write_mps
    from lp_gnn_tpu_torch.io.mps import LPData, read_mps, write_mps
    fn = str(tmp_path / "a.mps")
    if name == "random":
        rng = np.random.RandomState(5)
        m, n = 9, 15
        A = sprandom(m, n, density=0.4, random_state=rng, format="csr")
        b_u = rng.rand(m) * 10
        lp = LPData(c=rng.randn(n), b_l=np.where(rng.rand(m) < 0.5, b_u - 2,
                                                 -np.inf),
                    A=A, b_u=b_u, lb=np.where(rng.rand(n) < 0.2, -np.inf, 0.0),
                    ub=np.where(rng.rand(n) < 0.3, 5.0, np.inf),
                    con_nms=np.array([f"c{i}" for i in range(m)], dtype=object),
                    var_nms=np.array([f"x{j}" for j in range(n)], dtype=object))
        write_mps(lp, fn)
    elif name == "gz":
        fn += ".gz"
        with gzip.open(fn, "wt") as f:
            f.write(MPS_SAMPLES["ranges_bounds"])
    else:
        with open(fn, "w") as f:
            f.write(MPS_SAMPLES[name])
    got, want = read_mps(fn), jax_read_mps(fn)
    for field in ("c", "b_l", "b_u", "lb", "ub"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.A.toarray(), want.A.toarray())
    assert list(got.con_nms) == list(want.con_nms)
    assert list(got.var_nms) == list(want.var_nms)
    assert (got.name, got.obj_const) == (want.name, want.obj_const)
    write_mps(got, str(tmp_path / "port.mps"))
    jax_write_mps(want, str(tmp_path / "jax.mps"))
    assert (tmp_path / "port.mps").read_bytes() == \
        (tmp_path / "jax.mps").read_bytes()


def test_bas_formats_match_jax(tmp_path):
    """The CPLEX half of io/bas.py: write_bas_cplex writes the JAX bytes and
    read_bas reads them back (both formats); read_sol reads a CPLEX XML
    solution as the JAX reader does; check_lb / check_ub fix the same
    labels; an invalid basis is refused."""
    from lp_gnn_tpu.io import bas as jbas
    from lp_gnn_tpu_torch.io import bas as tbas
    con_nms = [f"c{i}" for i in range(4)]
    var_nms = [f"x{j}" for j in range(6)]
    pred_con = np.array([0, 1, 2, 1])
    pred_var = np.array([1, 0, 1, 0, 2, 0])
    tbas.write_bas_cplex(str(tmp_path / "t.bas"), var_nms, con_nms,
                         pred_var, pred_con)
    jbas.write_bas_cplex(str(tmp_path / "j.bas"), var_nms, con_nms,
                         pred_var, pred_con)
    assert (tmp_path / "t.bas").read_bytes() == (tmp_path / "j.bas").read_bytes()
    for got, want in zip(tbas.read_bas(str(tmp_path / "t.bas"), con_nms,
                                       var_nms), (pred_con, pred_var)):
        np.testing.assert_array_equal(got, want)
    tbas.write_bas_highs(str(tmp_path / "h.bas"), vbas=pred_var, cbas=pred_con)
    for got, want in zip(tbas.read_bas(str(tmp_path / "h.bas")),
                         jbas.read_bas(str(tmp_path / "h.bas"))):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not a valid basis"):
        tbas.write_bas_cplex(str(tmp_path / "d.bas"), ["x0"], ["c0"],
                             np.array([1]), np.array([1]))
    (tmp_path / "s.sol").write_text(
        '<?xml version="1.0"?>\n<CPLEXSolution><header/><quality/>'
        '<linearConstraints>'
        '<constraint name="c1" index="1" status="BS"/>'
        '<constraint name="c0" index="0" status="LL"/>'
        '</linearConstraints><variables>'
        '<variable name="x0" index="0" status="UL"/>'
        '<variable name="x1" index="1" status="BS"/>'
        '<variable name="x2" index="2" status="LL"/>'
        '</variables></CPLEXSolution>\n')
    for got, want in zip(tbas.read_sol(str(tmp_path / "s.sol")),
                         jbas.read_sol(str(tmp_path / "s.sol"))):
        np.testing.assert_array_equal(got, want)
    l = np.array([-np.inf, 0.0, -np.inf, 0.0])
    u = np.array([np.inf, np.inf, 1.0, np.inf])
    got, want = np.array([0, 0, 2, 2]), np.array([0, 0, 2, 2])
    tbas.check_lb(got, l), jbas.check_lb(want, l)
    tbas.check_ub(got, u), jbas.check_ub(want, u)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [0, 0, 2, 0]


LOG_TEXTS = [
    "Running HiGHS 1.8.0\nModel   status      : Optimal\n"
    "Simplex   iterations: 42\nHiGHS run time      :          0.25\n",
    "Running HiGHS 1.8.0\nModel   status      : Infeasible\n",
    "Running HiGHS 1.8.0\nModel   status      : WarmBasisRejected (ran cold)\n",
    "Running HiGHS 1.8.0\nModel   status      : Optimal\n",
    "CPLEX banner\nSolution time =    1.50 sec.  Iterations = 77 (3)\n",
    "unable open file x.mps\n",
    "Rank_deficiency 7\ntime elapsed for factorize: 1.5e-03\n",
]


def test_log_parsers_and_cells_match_jax():
    """The log parsers, the folder maps and the LaTeX cells of
    reporting/extract.py give the JAX package's answers."""
    pd = pytest.importorskip("pandas")
    from lp_gnn_tpu.reporting import extract as jx
    from lp_gnn_tpu_torch.reporting import extract as tx
    for text in LOG_TEXTS:
        assert tx.extract_time(text) == jx.extract_time(text), text
        assert tx.extract_nrepair(text) == jx.extract_nrepair(text), text
        assert tx.extract_fact_time(text) == jx.extract_fact_time(text), text
    for folder in ("gnn-bas-0", "gnn-bas-2-m4", "all-slacks-bas-1",
                   "highs-ca-bas-m1", "highs-no-bas", "warm-gate-calib"):
        assert tx.basis_folder_for_log(folder) == jx.basis_folder_for_log(folder)
        for col in (f"{folder}/niter", f"{folder}/time"):
            assert tx.map_back_to_baseline(col) == jx.map_back_to_baseline(col)
    for name in ("acc", "gnn-bas-0/impr_niter", "inf_time", "x/fact_time",
                 "highs-no-bas/niter"):
        for mean, std in ((0.5, 0.1), (29_900.0, 1_200.0), (0.01, 0.0),
                          (1_740_000.0, float("nan"))):
            s = pd.Series({"mean": mean, "std": std}, name=name)
            assert tx.proc(name, mean, std) == jx.proc(s), (name, mean, std)
