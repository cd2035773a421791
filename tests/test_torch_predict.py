"""The port's serving slice (processed blobs -> GCN_FC -> decode -> .bas)
against the JAX package's, on the CPU: the same fp32 weights on the same
4-LP dataset, written in the reference blob format, give identical .bas
files, and the port's decode gives the JAX decode's labels."""
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax

from lp_gnn_tpu.config import Config as JaxConfig
from lp_gnn_tpu.data.dataset import LPDataset as JaxDataset
from lp_gnn_tpu.infer import decode as jdecode
from lp_gnn_tpu.infer.predict import (
    predict_and_write_bases as jax_predict_and_write_bases)
from lp_gnn_tpu.models.gcn import build_model as jax_build_model
from lp_gnn_tpu.utils.serialize import msgpack_dump as jax_msgpack_dump
from lp_gnn_tpu_torch import pred_basis
from lp_gnn_tpu_torch.config import Config
from lp_gnn_tpu_torch.data.dataset import LPDataset
from lp_gnn_tpu_torch.infer import decode as tdecode
from lp_gnn_tpu_torch.infer.predict import (model_inference,
                                             predict_and_write_bases)
from lp_gnn_tpu_torch.io.bas import read_bas_highs
from lp_gnn_tpu_torch.models.convert import state_dict_from_jax_params
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.utils.serialize import df_load, have_pandas
from tests.test_torch_spmm import random_graph

torch.set_num_threads(2)

ARCH = "GCN_FC(8,8,hids=32,depth=3)"
N_LPS = 4


def write_processed(root, n_lps, seed=0):
    """n_lps processed LPs in the reference blob format, written by the JAX
    package's writer: [row, col, data, c_feas, v_feas, y_s, y_t, nnodes]
    plus the .meta sidecar (lp_gnn_tpu/data/dataset.py:98-108)."""
    rng = np.random.RandomState(seed)
    for i in range(n_lps):
        g, _ = random_graph(rng, m=20 + 5 * i, n=30 + 7 * i, e=120 + 20 * i)
        path = osp.join(root, "processed", f"lp_{i}.pk")
        jax_msgpack_dump([g.row, g.col, g.val.astype(np.float64), g.c_feas,
                          g.v_feas, g.y_s.astype(np.int64),
                          g.y_t.astype(np.int64), g.ncons + g.nvars], path)
        jax_msgpack_dump(dict(num_cons=g.ncons, num_vars=g.nvars,
                              raw_path="", processed_path=path,
                              con_nms=[f"c{k}" for k in range(g.ncons)],
                              var_nms=[f"x{k}" for k in range(g.nvars)]),
                         path + ".meta")


@pytest.fixture(scope="module")
def data_prefix(tmp_path_factory):
    prefix = tmp_path_factory.mktemp("torch_predict") / "lp-dataset"
    write_processed(str(prefix / "tiny" / "highs-inp_tgt"), N_LPS)
    return str(prefix)


@pytest.fixture(scope="module")
def params():
    model = jax_build_model(ARCH)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _files(d, sfx):
    return sorted(f for f in os.listdir(d) if f.endswith(sfx))


def test_bas_identical_to_jax(data_prefix, params, tmp_path):
    kw = dict(dataset="tiny", data_prefix=data_prefix,
              log_prefix=str(tmp_path), arch=ARCH)
    jcfg = JaxConfig(exp_nm="jax", **kw).finalize(make_log_dir=False)
    tcfg = Config(exp_nm="port", device="cpu", **kw).finalize(
        make_log_dir=False)
    assert tcfg.dataset_processed_prefix == jcfg.dataset_processed_prefix
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_predict_and_write_bases(
        jax_build_model(ARCH), params,
        JaxDataset(jcfg.dataset_processed_prefix, load_meta=True),
        jcfg, jax_out)
    model = build_model(ARCH)
    model.load_state_dict(state_dict_from_jax_params(params))
    predict_and_write_bases(
        model.eval(), LPDataset(tcfg.dataset_processed_prefix, load_meta=True),
        tcfg, port_out)
    bas = _files(jax_out, ".bas")
    assert len(bas) == N_LPS and _files(port_out, ".bas") == bas
    for f in bas:
        with open(osp.join(jax_out, f)) as a, open(osp.join(port_out, f)) as b:
            assert a.read() == b.read(), f
        # the P(basic) sidecar: the same numbers to fp32 round-off
        with open(osp.join(jax_out, f + ".sort")) as a, \
                open(osp.join(port_out, f + ".sort")) as b:
            la, lb = a.read().split("\n"), b.read().split("\n")
        assert [la[0], la[2]] == [lb[0], lb[2]]
        for i in (1, 3):
            np.testing.assert_allclose(np.array(lb[i].split(), float),
                                       np.array(la[i].split(), float),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("spec", [
    "InferenceManager(0,)", "InferenceManager(1,)",
    "InferenceManager(2, mode='add', gnn_wei=0.3)",
    "InferenceManager(2, mode=1, run=2)", "auto"])
def test_decode_labels_identical(spec):
    """For identical logits the port's decode gives infer/decode.py's
    labels, for every decode function and its configured options."""
    rng = np.random.RandomState(len(spec))
    m, n = 30, 70
    logits = (rng.randn(m + n, 3) * 5).astype(np.float32)
    logits[rng.rand(m + n) < 0.2, 1] = 2.0   # ties in P(basic)
    nnzs = np.concatenate([np.ones(m), rng.randint(0, 5, n)])
    tm = tdecode.parse_inference_manager(spec, "svm-perm")
    jm = jdecode.parse_inference_manager(spec, "svm-perm")
    assert tm.get_basis_folder() == jm.get_basis_folder()
    assert tm.get_log_folder() == jm.get_log_folder()
    assert tm.decode_kwargs() == jm.decode_kwargs()
    got = tm.decode_fn()(logits, m, nnzs=nnzs, **tm.decode_kwargs())
    want = jm.decode_fn()(logits, m, nnzs=nnzs, **jm.decode_kwargs())
    np.testing.assert_array_equal(got, want)


def _cli(data_prefix, log_prefix, *extra):
    return ["--dataset", "tiny", "--data_prefix", data_prefix,
            "--log_prefix", log_prefix, "--exp_nm", "cli", "--arch", ARCH,
            *extra]


def test_pred_basis_cli_on_cpu(data_prefix, params, tmp_path):
    """The entry point end to end: a mdl.pth in, valid .bas + .sort and the
    per-LP inference times out."""
    model = build_model(ARCH)
    model.load_state_dict(state_dict_from_jax_params(params))
    ckpt = str(tmp_path / "mdl.pth")
    torch.save(model.state_dict(), ckpt)
    out_dir = pred_basis.main(_cli(
        data_prefix, str(tmp_path / "runs"), "--load_from", ckpt,
        "--split", "trainval", "--warm_gate", "off", "--device", "cpu"))
    bas = _files(out_dir, ".bas")
    assert len(bas) == N_LPS and len(_files(out_dir, ".bas.sort")) == N_LPS
    for f in bas:
        con, var = read_bas_highs(osp.join(out_dir, f))
        assert int((con == 1).sum() + (var == 1).sum()) == len(con)
        assert int((var == 1).sum()) == int(((con == 0) | (con == 2)).sum())
    log_dir = osp.dirname(out_dir.rstrip("/"))
    with open(osp.join(log_dir, "inf_time.json")) as f:
        inf = json.load(f)
    assert inf["device"] == "cpu"
    assert sorted(inf["inf_time"]) == [f"lp_{i}" for i in range(N_LPS)]
    assert all(t > 0 for t in inf["inf_time"].values())


def _decision_margins(logits, m):
    """Per node, how far its label is from flipping under the top-m decode:
    the log-P(basic) gap to the other side of the m-th place, and the gap
    between its LL and UL logits."""
    lp = logits - np.logaddexp.reduce(logits, axis=1, keepdims=True)
    b = lp[:, 1]
    ranked = np.sort(b)[::-1]
    gap_basis = np.where(b >= ranked[m - 1], b - ranked[m], ranked[m - 1] - b)
    return gap_basis, np.abs(logits[:, 0] - logits[:, 2])


def test_pred_basis_cli_edge_partitioned(data_prefix, params, tmp_path):
    """``--mesh_shape edge=2 --edge_num_thresh 0`` runs every LP through the
    edge-partitioned forward on the CPU: valid .bas files equal to the run
    without the mesh, a label differing only where that node's decision is
    within the fp32 dist tolerance (5e-4 a logit, tests/test_parallel.py:43)
    of flipping; ``part_time`` beside ``inf_time``; the partitions cached as
    the port's own files."""
    model = build_model(ARCH)
    model.load_state_dict(state_dict_from_jax_params(params))
    ckpt = str(tmp_path / "mdl.pth")
    torch.save(model.state_dict(), ckpt)
    common = ("--load_from", ckpt, "--split", "trainval", "--warm_gate", "off",
              "--device", "cpu")
    single = pred_basis.main(_cli(data_prefix, str(tmp_path / "single"),
                                  *common))
    dist = pred_basis.main(_cli(data_prefix, str(tmp_path / "dist"), *common,
                                "--mesh_shape", "edge=2",
                                "--edge_num_thresh", "0"))
    bas = _files(dist, ".bas")
    assert bas == _files(single, ".bas") and len(bas) == N_LPS
    ds = LPDataset(osp.join(data_prefix, "tiny", "highs-inp_tgt"))
    tol = 5e-4
    for i, f in enumerate(bas):
        con, var = read_bas_highs(osp.join(dist, f))
        assert int((con == 1).sum() + (var == 1).sum()) == len(con)
        assert int((var == 1).sum()) == int(((con == 0) | (con == 2)).sum())
        want = np.concatenate(read_bas_highs(osp.join(single, f)))
        diff = np.flatnonzero(np.concatenate([con, var]) != want)
        if len(diff):
            g = ds[int(f[len("lp_"):-len(".bas")])]
            logits = np.concatenate(model_inference(model.eval(), g))
            gap_basis, gap_lu = _decision_margins(logits, g.ncons)
            assert ((gap_basis[diff] <= 4 * tol) | (gap_lu[diff] <= 2 * tol)).all()
    log_dir = osp.dirname(dist.rstrip("/"))
    with open(osp.join(log_dir, "inf_time.json")) as f:
        inf = json.load(f)
    names = [f"lp_{i}" for i in range(N_LPS)]
    assert sorted(inf["inf_time"]) == names and sorted(inf["part_time"]) == names
    assert all(t > 0 for t in (*inf["inf_time"].values(),
                               *inf["part_time"].values()))
    if have_pandas():
        df = df_load(osp.join(log_dir, "time.h5")).set_index("fn")
        assert (df.loc[names, "part_time"] > 0).all()
    parts = os.listdir(osp.join(data_prefix, "tiny", "highs-inp_tgt",
                                "partitions"))
    assert len(parts) == N_LPS and all(p.endswith(".tpart.npz") for p in parts)


def test_warm_gate_auto_runs(data_prefix, params, tmp_path):
    """``--warm_gate auto`` (the default) calibrates the warm starts in the
    predict stage and writes ``warm_gate.json``. This dataset has no MPS
    files and no cold logs, so no LP can be calibrated: the gate proceeds
    with k = 0, as predict.py:314 rules for no data."""
    model = build_model(ARCH)
    model.load_state_dict(state_dict_from_jax_params(params))
    ckpt = str(tmp_path / "mdl.pth")
    torch.save(model.state_dict(), ckpt)
    out_dir = pred_basis.main(_cli(data_prefix, str(tmp_path / "runs"),
                                   "--load_from", ckpt, "--device", "cpu"))
    assert len(_files(out_dir, ".bas")) == 2   # the val split of 4 LPs
    with open(osp.join(osp.dirname(out_dir.rstrip("/")),
                       "warm_gate.json")) as f:
        gate = json.load(f)
    assert gate["proceed"] is True and gate["k"] == 0
    assert gate["decode"] == "pred-basis" and gate["lps"] == []


# explicit ids keep each case's test name
@pytest.mark.parametrize("extra", [
    pytest.param(["--warm_gate", "off", "--edge_num_thresh", "100",
                  "--batch_size", "17"], id="extra2-sampling"),
])
def test_unported_routes_raise(data_prefix, params, tmp_path, extra):
    """The route of each case, once refused (it named its ROADMAP item),
    now runs: graphs above --edge_num_thresh take exact sampled shards of
    --batch_size seeds, which give GCN_FC the full graph's logits, so the
    entry point writes the full-graph route's .bas files."""
    model = build_model(ARCH)
    model.load_state_dict(state_dict_from_jax_params(params))
    ckpt = str(tmp_path / "mdl.pth")
    torch.save(model.state_dict(), ckpt)
    outs = [pred_basis.main(_cli(data_prefix, str(tmp_path / run),
                                 "--device", "cpu", "--load_from", ckpt,
                                 *args))
            for run, args in (("sampled", extra),
                              ("full", ["--warm_gate", "off"]))]
    bas = _files(outs[0], ".bas")
    assert bas and bas == _files(outs[1], ".bas")
    for f in bas:
        with open(osp.join(outs[0], f)) as a, open(osp.join(outs[1], f)) as b:
            assert a.read() == b.read(), f
