"""The twin of scripts/run_family_table.sh against the script and the JAX
package, on the CPU.

(a) Its constants and flags are the script's (the script's text, read).
(b) Two families at a cut run end to end: valid bases, the warm gate, the
    svm gate-off folders beside run 0's, which they leave byte for byte,
    one row a family, and a second call that reuses the prepped data.
(c) The gate-off pass from one JAX ``mdl.ckpt``: the JAX package's stages
    as the script runs them, and the twin's pass, give equal ``.bas``
    files, equal ``gnn-bas-1`` iterations and equal table rows.
"""
import glob
import math
import os
import os.path as osp
import re
import shlex

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX side runs on the CPU)

from lp_gnn_tpu import pipeline as jpipeline
from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.reporting.extract import extract_time as jax_extract_time
from lp_gnn_tpu.train.trainer import run_exp as jax_run_exp
from lp_gnn_tpu_torch import run_family_table as rft
from lp_gnn_tpu_torch.data.generator import SIZES
from lp_gnn_tpu_torch.infer.decode import parse_inference_manager
from lp_gnn_tpu_torch.io.bas import read_bas_highs
from lp_gnn_tpu_torch.reporting.extract import extract_time, summarize
from lp_gnn_tpu_torch.solver.highs_bridge import HAVE_HIGHS
from lp_gnn_tpu_torch.utils.log import run_dir_logs
from lp_gnn_tpu_torch.utils.serialize import json_load
from tests.test_torch_pipeline import RTOL, cwd, prep_both

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not HAVE_HIGHS, reason="no vendored highspy")

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCRIPT = osp.join(ROOT, "scripts", "run_family_table.sh")
TINY_ARCH = "GCN_FC(8,8,hids=16,depth=3)"
# 8 LPs: 5 train (the gate's first k), 3 val
CUT = dict(families=("transport", "svm"), n_instances=8, epochs=3,
           arch=TINY_ARCH, device="cpu")
N_VAL = 3
ROW_KEYS = {"family", "gate", "cold_niter", "decode", "warm_niter", "impr",
            "rejected", "gate_off_niter", "gate_off_impr",
            "gate_off_rejected", "acc", "run_dir", "seconds"}


# ------------------------------------------------------- (a) the script
def script_text() -> str:
    with open(SCRIPT) as f:
        return f.read().replace("\\\n", " ")


def script_commands() -> list[tuple[str, tuple[str, ...], dict]]:
    """(script, the families of its loop, its flags) for each python
    command of the script, in order."""
    out, fams = [], ()
    for line in script_text().splitlines():
        line = line.strip()
        loop = re.match(r"for fam in ([^;]+); do$", line)
        if loop:
            fams = tuple(loop.group(1).split())
        elif line.startswith("python "):
            toks = shlex.split(line)
            out.append((toks[1], fams, dict(zip(toks[2::2], toks[3::2]))))
    return out


def flags(argv: list[str]) -> dict:
    assert len(argv) % 2 == 0 and all(a.startswith("--") for a in argv[::2])
    return dict(zip(argv[::2], argv[1::2]))


def test_constants_are_the_scripts():
    text = script_text()
    assert re.search(r'^ARCH="([^"]+)"$', text, re.M).group(1) == rft.ARCH
    cmds = script_commands()
    assert [c[0] for c in cmds] == [
        "run_prep_data.py", "run_train_test.py", "scripts/pred_basis.py",
        "scripts/run_solver_from_basis.py", "scripts/extract_time.py"]
    (_, fams, prep), (_, fams2, train), (_, off_fams, pred), \
        (_, _, warm), (_, _, extract) = cmds
    assert fams == fams2 == rft.FAMILIES
    assert off_fams == rft.GATE_OFF_FAMILIES
    assert prep == {"--dataset": "$fam", "--n_instances": str(rft.N_INSTANCES),
                    "--size": rft.SIZE, "--num_workers": str(rft.NUM_WORKERS),
                    "--skip_exist": str(rft.SKIP_EXIST)}
    assert train == {"--dataset": "$fam", "--exp_nm": "r4-$fam-ep300",
                     "--arch": "$ARCH", "--epochs": str(rft.EPOCHS),
                     "--loss": rft.LOSS,
                     "--inference_manager": rft.INFERENCE_MANAGER,
                     "--warm_gate": rft.WARM_GATE}
    assert pred == {"--dataset": "$fam", "--exp_nm": "r4-$fam-ep300",
                    "--arch": "$ARCH",
                    "--load_from": "runs/r4-$fam-ep300/mdl.ckpt",
                    "--inference_manager": rft.GATE_OFF_MANAGER,
                    "--warm_gate": rft.GATE_OFF_WARM_GATE}
    assert warm == {k: pred[k] for k in ("--dataset", "--exp_nm",
                                         "--inference_manager", "--warm_gate")}
    assert extract == {k: pred[k] for k in ("--dataset", "--exp_nm")}


@pytest.mark.parametrize("fam", rft.FAMILIES)
def test_flags_are_the_scripts(fam):
    """The twin's argv for each command is the script's with $fam and $ARCH
    filled in; the gate-off ``--load_from`` is the run's ``mdl.pth`` where
    the script's is its ``mdl.ckpt``."""
    (_, _, prep), (_, _, train), (_, _, pred), *_ = script_commands()

    def filled(d):
        return {k: v.replace("$fam", fam).replace("$ARCH", rft.ARCH)
                for k, v in d.items()}

    assert flags(rft.prep_argv(fam)) == filled(prep)
    assert flags(rft.train_argv(fam)) == filled(train)
    ckpt = f"runs/{rft.exp_name(fam)}/mdl.pth"
    assert flags(rft.gate_off_argv(fam, ckpt)) == {
        **filled(pred), "--load_from": ckpt}
    assert filled(pred)["--load_from"] == ckpt[:-len(".pth")] + ".ckpt"


# ------------------------------------------------------- (b) at a cut
def tree_bytes(root: str) -> dict:
    out = {}
    for p in sorted(glob.glob(f"{root}/**/*", recursive=True)):
        if osp.isfile(p):
            with open(p, "rb") as f:
                out[osp.relpath(p, root)] = f.read()
    return out


def system_folders(fam: str) -> tuple[str, str]:
    """(bases, logs) of the decode ``auto`` picks for ``fam``."""
    mng = parse_inference_manager(rft.INFERENCE_MANAGER, fam)
    return mng.get_basis_folder(), mng.get_log_folder()


def run0_files(log_dir: str, fam: str) -> dict:
    """The first pass's files that the gate-off pass must leave: the gate,
    the decode's bases, the warm starts' bases and logs."""
    bases, logs = system_folders(fam)
    out = {}
    for sub in (bases, f"opt-from-{bases}", f"log/{logs}",
                "warm-gate-calib", "log/warm-gate-calib"):
        out.update({osp.join(sub, k): v for k, v in
                    tree_bytes(osp.join(log_dir, sub)).items()})
    with open(osp.join(log_dir, "warm_gate.json"), "rb") as f:
        out["warm_gate.json"] = f.read()
    return out


@pytest.fixture(scope="module")
def tiny_table(tmp_path_factory):
    """The twin over transport and svm at the cut, with the run-0 files of
    each gate-off family taken just before its gate-off pass."""
    root = tmp_path_factory.mktemp("family_table")
    mp = pytest.MonkeyPatch()
    before = {}
    real = rft.gate_off_pass

    def watched(argv, log_dir):
        fam = flags(argv)["--dataset"]
        before[fam] = (run0_files(log_dir, fam),
                       json_load(osp.join(log_dir, "time.json")))
        real(argv, log_dir)

    mp.setattr(rft, "gate_off_pass", watched)
    try:
        with cwd(str(root)):
            rows = rft.family_table(**CUT)
    finally:
        mp.undo()
    return str(root), rows, before


def valid_basis(path: str) -> bool:
    con, var = read_bas_highs(path)
    return (int((con == 1).sum() + (var == 1).sum()) == len(con)
            and int((var == 1).sum()) == int(((con == 0) | (con == 2)).sum()))


def test_tiny_table_bases_valid(tiny_table):
    """Every val LP has a valid basis in the decode's folder, and svm's in
    the gate-off folder too; a warm log each, none rejected."""
    root, rows, _ = tiny_table
    for row in rows:
        run = osp.join(root, row["run_dir"])
        folders = [system_folders(row["family"])[0]] + (["pred-basis-1"]
                                     if row["family"] == "svm" else [])
        for folder in folders:
            bases = sorted(glob.glob(f"{run}/{folder}/*.bas"))
            assert len(bases) == N_VAL and all(map(valid_basis, bases)), \
                (row["family"], folder)
        assert len(os.listdir(osp.join(run, "log", row["decode"]))) == N_VAL
        assert row["rejected"] == 0


def test_tiny_table_warm_gate(tiny_table):
    root, rows, _ = tiny_table
    for row in rows:
        gate = json_load(osp.join(root, row["run_dir"], "warm_gate.json"))
        assert 5 <= gate["k"] <= 12, row["family"]
        assert row["gate"] == {k: gate[k] for k in
                               ("proceed", "mean_impr", "k", "failures")}
        assert gate["decode"] == system_folders(row["family"])[0]
    assert [r["decode"] for r in rows] == ["gnn-bas-0",
                                          "gnn-sparsity-mult-None-0"]


def test_tiny_table_gate_off_beside_run0(tiny_table):
    """svm's gate-off pass writes pred-basis-1, opt-from-pred-basis-1 and
    log/gnn-bas-1 into the first pass's run dir (no second dir), leaves
    every run-0 file byte for byte and every run-0 number of the table but
    the re-timed inf_time; transport has no gate-off pass."""
    root, rows, before = tiny_table
    assert set(before) == {"svm"}
    svm = osp.join(root, rows[1]["run_dir"])
    assert sorted(os.listdir(osp.join(root, "runs"))) == [
        "r4-svm-ep3", "r4-transport-ep3"]
    # the predicted bases with their .bas.sort, the bases the warm starts
    # converged to, the warm logs
    for sub, n in (("pred-basis-1", 2 * N_VAL), ("opt-from-pred-basis-1", N_VAL),
                   ("log/gnn-bas-1", N_VAL)):
        assert len(os.listdir(osp.join(svm, sub))) == n, sub
    files, table = before["svm"]
    assert run0_files(svm, "svm") == files
    after = {r["fn"]: r for r in json_load(osp.join(svm, "time.json"))}
    for r in table:
        for k, v in r.items():
            if k != "inf_time":
                assert after[r["fn"]][k] == v, (r["fn"], k)
    assert not osp.exists(osp.join(root, rows[0]["run_dir"], "pred-basis-1"))


def test_tiny_table_rows(tiny_table):
    """One row a family with every column, each number the val split's mean
    in the run's time.json; the gate-off columns only for svm."""
    root, rows, _ = tiny_table
    assert [r["family"] for r in rows] == ["transport", "svm"]
    for row in rows:
        assert set(row) == ROW_KEYS
        run = osp.join(root, row["run_dir"])
        val = summarize(json_load(osp.join(run, "time.json")))["val"]
        assert row["cold_niter"] == val["highs-no-bas/niter"][0] > 0
        assert row["warm_niter"] == val[f"{row['decode']}/niter"][0]
        assert row["impr"] == val[f"{row['decode']}/impr_niter"][0]
        assert row["acc"] == val["acc"][0]
        if not row["gate"]["proceed"]:   # declined: the val split solves cold
            assert row["warm_niter"] == row["cold_niter"] and row["impr"] == 0
        gated = row["family"] == "svm"
        assert set(row["seconds"]) == {"prep", "run_train_test"} | (
            {"gate_off"} if gated else set())
        if gated:
            assert row["gate_off_niter"] == val["gnn-bas-1/niter"][0]
            assert row["gate_off_impr"] == val["gnn-bas-1/impr_niter"][0]
            assert row["gate_off_rejected"] == 0
        else:
            assert row["gate_off_niter"] is row["gate_off_impr"] is None


def test_tiny_table_rerun_reuses_prep(tiny_table):
    """A second call (skip_exist 1, as the script's) leaves the prepped
    tree byte for byte, and runs in run dirs of its own epochs."""
    root, _, _ = tiny_table
    data = osp.join(root, "lp-dataset")
    want = tree_bytes(data)
    assert len([p for p in want if "/mps/" in p]) == 2 * CUT["n_instances"]
    with cwd(root):
        rows = rft.family_table(**{**CUT, "epochs": 1})
    assert tree_bytes(data) == want
    assert [r["run_dir"] for r in rows] == ["runs/r4-transport-ep1/",
                                            "runs/r4-svm-ep1/"]


# ------------------------------------------------- (c) gate-off vs JAX
GATE_OFF_EPOCHS = 4


@pytest.fixture(scope="module")
def gate_off_both(tmp_path_factory):
    """A tiny svm family prepped by both packages; a JAX mdl.ckpt; the
    script's gate-off commands through the JAX package's stages in its run
    dir, and the twin's gate-off pass from the same checkpoint."""
    root = str(tmp_path_factory.mktemp("family_gate_off"))
    prep_both(root, "svm", family="svm", n_instances=8,
              **SIZES["svm"]["small"])
    exp = rft.exp_name("svm", GATE_OFF_EPOCHS)
    sides = {s: dict(data_prefix=osp.join(root, s, "lp-dataset"),
                     log_prefix=osp.join(root, s, "runs"))
             for s in ("jax", "port")}
    ckpt = jax_run_exp(JaxConfig(exp_nm=exp, dataset="svm", arch=TINY_ARCH,
                                 epochs=GATE_OFF_EPOCHS, seed=0,
                                 **sides["jax"]).finalize())
    jcfg = JaxConfig(exp_nm=exp, dataset="svm", arch=TINY_ARCH,
                     load_from=ckpt, seed=0,
                     inference_manager=rft.GATE_OFF_MANAGER,
                     warm_gate=rft.GATE_OFF_WARM_GATE,
                     **sides["jax"]).finalize()
    assert osp.dirname(ckpt) == osp.normpath(jcfg.log_dir)
    jpipeline.stage_pred_basis(jcfg)
    jpipeline.stage_warm_start(jcfg)
    jdf, _ = jpipeline.stage_extract(jcfg)
    port_run = osp.join(sides["port"]["log_prefix"], exp)
    os.makedirs(port_run)
    common = [x for k, v in sides["port"].items() for x in (f"--{k}", v)]
    with run_dir_logs():
        rft.gate_off_pass([*rft.gate_off_argv("svm", ckpt, GATE_OFF_EPOCHS,
                                              TINY_ARCH),
                           *common, "--seed", "0", "--device", "cpu"],
                          port_run)
    return jcfg.log_dir, port_run, jdf


def test_gate_off_bases_equal_jax(gate_off_both):
    jrun, trun, _ = gate_off_both
    for folder in ("pred-basis-1", "opt-from-pred-basis-1"):
        names = sorted(os.listdir(osp.join(jrun, folder)))
        assert names == sorted(os.listdir(osp.join(trun, folder)))
        bases = [f for f in names if f.endswith(".bas")]
        assert len(bases) == 3
        for f in bases:   # (a .bas.sort holds float probabilities)
            with open(osp.join(jrun, folder, f), "rb") as a, \
                    open(osp.join(trun, folder, f), "rb") as b:
                assert a.read() == b.read(), (folder, f)


def test_gate_off_iterations_equal_jax(gate_off_both):
    jrun, trun, _ = gate_off_both
    logs = sorted(os.listdir(osp.join(trun, "log", "gnn-bas-1")))
    assert logs == sorted(os.listdir(osp.join(jrun, "log", "gnn-bas-1")))
    assert len(logs) == 3
    for f in logs:
        got = extract_time(osp.join(trun, "log", "gnn-bas-1", f))[0]
        want = jax_extract_time(osp.join(jrun, "log", "gnn-bas-1", f))[0]
        assert got == want >= 0, f


def test_gate_off_table_equal_jax(gate_off_both):
    """The twin's time.json holds the JAX time.h5's numbers after the
    gate-off pass (iterations exactly, ratios to RTOL; times not compared),
    and its gnn-bas-1 val mean is JAX's."""
    _, trun, jdf = gate_off_both
    rows = json_load(osp.join(trun, "time.json"))
    cols = [c for c in jdf.columns if "time" not in c and c != "fn"]
    assert {k for r in rows for k in r if "time" not in k} == {*cols, "fn"}
    assert {"highs-no-bas/niter", "gnn-bas-1/niter",
            "gnn-bas-1/impr_niter"} <= set(cols)
    jdf = jdf.set_index("fn")
    for r in rows:
        for c in cols:
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
    mean = summarize(rows)["val"]["gnn-bas-1/impr_niter"][0]
    want = jdf[jdf.split == "val"]["gnn-bas-1/impr_niter"].mean()
    np.testing.assert_allclose(mean, want, rtol=RTOL)
