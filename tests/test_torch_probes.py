"""The port's twins of ``scripts/probe_spmm.py`` and
``scripts/probe_gen_floor.py`` (lp_gnn_tpu_torch/probe_spmm.py,
lp_gnn_tpu_torch/probe_gen_floor.py) and its copy of ``block_layout``,
against the JAX package on the CPU, where every kernel wrapper runs its
plain version: each probe's op against the JAX expression the script
times, on the same numpy inputs at a small shape in fp32, and each twin's
``main`` at a tiny size.

Tolerances:
- ``block_layout``, ``chunk_ptr`` and ``pick_block_k``: byte for byte;
- the row and window gathers, the transpose, the message build (5b), the
  segment max (its empty segments -inf both sides) and the gather's
  forward: exact;
- the one-hot contractions (4, 5c), the dense bmm (6), the blocked
  traversal (5) and ``spmm_csr`` against JAX's ``blocked_spmm`` over
  JAX's layout, the segment sums (4a, 4b; empty segments 0), the gather's
  backward, the GEN direction's output and its input gradient: rtol 1e-5
  (the same fp32 products summed in another order), with atol 1e-6 where
  a sum can cancel to near 0 (all but the one-hot window contraction).
"""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lp_gnn_tpu.data import batching as jbatching
from lp_gnn_tpu.models.gen import gen_dir_apply, gen_dir_init
from lp_gnn_tpu.ops.spmm import blocked_spmm as jax_blocked_spmm
from lp_gnn_tpu.ops.spmm import gather_src
from lp_gnn_tpu_torch import probe_gen_floor as pgf
from lp_gnn_tpu_torch import probe_spmm as ps
from lp_gnn_tpu_torch.data.stacking import (block_layout, chunk_ptr,
                                            pick_block_k)
from lp_gnn_tpu_torch.models.convert import _put_gen_dir
from lp_gnn_tpu_torch.models.gen import GENConv
from lp_gnn_tpu_torch.ops.spmm import spmm_csr

torch.set_num_threads(2)

T = torch.from_numpy


def bench_edges(e=20_000, m=512, n=2048, seed=0):
    """probe_spmm's v2c edges: sorted rows, random columns and values."""
    rng = np.random.RandomState(seed)
    row = np.sort(rng.randint(0, m, e).astype(np.int32))
    return row, rng.randint(0, n, e).astype(np.int32), \
        rng.rand(e).astype(np.float32)


# ------------------------------------------------------------ block layout
@pytest.mark.parametrize("case", ["bench", "empty_rows", "no_edges",
                                  "skewed"])
def test_block_layout_is_jax_byte_for_byte(case):
    m = 512
    row, col, val = bench_edges(m=m)
    if case == "empty_rows":      # every row of blocks 1 and 3 empty
        keep = ~np.isin(row // 128, [1, 3])
        row, col, val = row[keep], col[keep], val[keep]
        m = 600                   # and a tail of empty rows past the last
    elif case == "no_edges":
        row, col, val = row[:0], col[:0], val[:0]
    elif case == "skewed":        # one row takes a third of the edges
        row = np.sort(np.where(np.arange(row.size) % 3 == 0, 5, row))
    for k in (pick_block_k(row.size, m), 512, 1024):
        got = block_layout(row, col, val, m, k=k)
        want = jbatching.block_layout(row, col, val, m, K=k)
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        assert got[4] == want[4]
        np.testing.assert_array_equal(chunk_ptr(got[3], got[4]),
                                      jbatching._chunk_ptr(want[3], want[4]))
        assert chunk_ptr(got[3], got[4]).dtype == np.int32


@pytest.mark.parametrize("e_pad,num_dst", [(1_000_000, 65_536), (3000, 500),
                                           (0, 1), (10 ** 8, 262_144),
                                           (700, 128), (5_000_000, 1)])
def test_pick_block_k_is_jax(e_pad, num_dst):
    assert pick_block_k(e_pad, num_dst) == \
        jbatching.pick_block_k(e_pad, num_dst)


# ------------------------------------------------------------ probe_spmm
def test_gathers_and_transpose_are_exact():
    rng = np.random.RandomState(1)
    x = rng.randn(1024, 16).astype(np.float32)
    idx = rng.randint(0, 1024, 3000).astype(np.int32)
    assert torch.equal(ps.row_gather(T(x), T(idx)),
                       T(np.array(jnp.asarray(x)[idx])))
    xw = x.reshape(1024 // 128, 128 * 16)
    widx = rng.randint(0, 8, 50).astype(np.int32)
    assert torch.equal(ps.row_gather(T(xw), T(widx)),
                       T(np.array(jnp.asarray(xw)[widx])))
    a = rng.randn(6, 4, 5, 16).astype(np.float32)
    got = ps.hbm_transpose(T(a))
    assert got.is_contiguous()
    assert torch.equal(got, T(np.array(jnp.swapaxes(jnp.asarray(a), 0, 1))))


def test_onehot_contractions_and_bmm_match_jax():
    rng = np.random.RandomState(2)
    c, k, w, d = 6, 32, 16, 8
    loc = rng.randint(0, w, (c, k)).astype(np.int32)
    win = rng.randn(c, w, d).astype(np.float32)
    oh = (jnp.asarray(loc)[..., None] ==
          jax.lax.broadcasted_iota(jnp.int32, (1, 1, w), 2)).astype(jnp.float32)
    want = jnp.einsum("ckw,cwd->ckd", oh, win,
                      preferred_element_type=jnp.float32)
    got = ps.onehot_contract(T(loc), T(win))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    a6 = rng.randn(c, k, w).astype(np.float32)
    np.testing.assert_allclose(
        ps.dense_bmm(T(a6), T(win)).numpy(),
        np.asarray(jnp.einsum("ckw,cwd->ckd", a6, win,
                              preferred_element_type=jnp.float32)),
        rtol=1e-5, atol=1e-6)


def test_blocked_traversal_and_spmm_csr_match_jax_blocked_spmm():
    """Probe 5: the port's blocked traversal and its parts (5b, 5c) over
    the port's layout, and spmm_csr on the same edges as CSR, against
    JAX's blocked_spmm over JAX's layout."""
    m, n, d = 512, 2048, 16
    row, col, val = bench_edges(m=m, n=n)
    x = np.random.RandomState(4).randn(n, d).astype(np.float32)
    k = pick_block_k(row.size, m)
    bs, bd, bv, bo, nblk = block_layout(row, col, val, m, k=k)
    jl = jbatching.block_layout(row, col, val, m, K=k)
    want = np.asarray(jax_blocked_spmm(*(jnp.asarray(a) for a in jl[:4]),
                                       jnp.asarray(x), None, jl[4]))[:m]
    chunks = T(np.diff(chunk_ptr(bo, nblk)))
    got = ps.blocked_spmm(T(bs), T(bd), T(bv), chunks, T(x))
    np.testing.assert_allclose(got[:m].numpy(), want, rtol=1e-5, atol=1e-6)
    assert not got[m:].any()
    np.testing.assert_allclose(
        spmm_csr(T(ps.csr_ptr(row, m)), T(col), T(val), T(x)).numpy(), want,
        rtol=1e-5, atol=1e-6)
    msg = ps.msg_build(T(bs), T(bv), T(x))
    assert torch.equal(msg, T(np.array(
        jnp.asarray(x)[bs] * jnp.asarray(bv)[..., None])))
    oh = (jnp.asarray(bd)[..., None] == jax.lax.broadcasted_iota(
        jnp.int32, (1, 1, 128), 2)).astype(jnp.float32)
    np.testing.assert_allclose(
        ps.dst_contract(T(bd), msg).numpy(),
        np.asarray(jnp.einsum("bkr,bkd->brd", oh, msg.numpy(),
                              preferred_element_type=jnp.float32)),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- probe_gen_floor
def gen_inputs(e=3000, m=200, n=500, d=16, seed=0, empty=True):
    """Sorted rows (with empty segments where ``empty``), columns, an
    (E, D) stream, the transpose ordering."""
    rng = np.random.RandomState(seed)
    row = np.sort(rng.randint(0, m, e).astype(np.int32))
    if empty:
        row[np.isin(row, [0, 7, 8, m - 1])] = 9
        row.sort()
    col = rng.randint(0, n, e).astype(np.int32)
    stream = (rng.rand(e, d).astype(np.float32) - 0.5)
    perm = np.argsort(col, kind="stable").astype(np.int32)
    return row, col, stream, perm


def test_segment_floors_match_jax():
    m = 200
    row, _, a, _ = gen_inputs(m=m)
    lengths = T(np.bincount(row, minlength=m))
    want_max = np.asarray(jax.ops.segment_max(
        a, row, num_segments=m, indices_are_sorted=True))
    got_max = pgf.segment_max(T(a), lengths).numpy()
    assert np.isneginf(want_max[0]).all() and np.isneginf(got_max[0]).all()
    np.testing.assert_array_equal(got_max, want_max)
    want_sum = np.asarray(jax.ops.segment_sum(
        a, row, num_segments=m, indices_are_sorted=True))
    got_sum = pgf.segment_sum_f32(T(a), lengths)
    assert got_sum.dtype == torch.float32 and not got_sum[0].any()
    np.testing.assert_allclose(got_sum.numpy(), want_sum, rtol=1e-5,
                               atol=1e-6)
    want2 = np.asarray(jax.ops.segment_sum(
        jnp.concatenate([a, a * a], axis=1), row, num_segments=m,
        indices_are_sorted=True))
    np.testing.assert_allclose(pgf.fused_segment_sum_f32(T(a), lengths)
                               .numpy(), want2, rtol=1e-5, atol=1e-6)
    assert float(pgf.stream_read(T(a))) == pytest.approx(float(a.sum()),
                                                         rel=1e-5, abs=1e-4)


def test_gather_fwd_bwd_matches_gather_src():
    n, d = 500, 16
    _, col, _, perm = gen_inputs(n=n, d=d)
    rng = np.random.RandomState(5)
    x = rng.randn(n, d).astype(np.float32)
    ct = rng.randn(col.size, d).astype(np.float32)
    t_seg = col[perm]

    def f(xx):
        return gather_src(xx, jnp.asarray(col), jnp.asarray(t_seg),
                          jnp.asarray(perm), n)
    want_fwd, vjp = jax.vjp(f, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(ct))
    t_ptr = T(ps.csr_ptr(col, n))
    fwd, dx = pgf.gather_fwd_bwd(T(x), T(col), t_ptr, T(perm), T(ct))
    assert torch.equal(fwd, T(np.array(want_fwd)))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5,
                               atol=1e-6)


def test_gen_direction_matches_gen_dir_apply():
    """One GEN direction (v2c) from gen_dir_init's weights: the output and
    the gradient for x of its sum, against gen_dir_apply with the
    transpose ordering's permutation."""
    e, m, n, d = 3000, 200, 500, 16
    row, col, _, perm = gen_inputs(e, m, n, d)
    rng = np.random.RandomState(6)
    x = (rng.rand(n, d).astype(np.float32) - 0.5)
    x_dst = (rng.rand(m, d).astype(np.float32) - 0.5)
    val = rng.rand(e).astype(np.float32) - 0.5
    p = gen_dir_init(jax.random.PRNGKey(0), d, d, d)
    sd = {}
    _put_gen_dir(sd, "dir", jax.tree.map(np.asarray, p))
    conv = GENConv(d, d, d)
    conv.load_state_dict({k[len("dir."):]: v for k, v in sd.items()})
    conv.requires_grad_(False)
    args = (jnp.asarray(col), jnp.asarray(row), jnp.asarray(val))
    tr = (jnp.asarray(col[perm]), jnp.asarray(perm))

    def f(xx):
        return gen_dir_apply(p, *args, xx, jnp.asarray(x_dst), m,
                             jnp.int32(e), *tr, n)
    want = np.asarray(f(jnp.asarray(x)))
    want_dx = np.asarray(jax.grad(
        lambda xx: jnp.sum(f(xx).astype(jnp.float32)))(jnp.asarray(x)))
    graph = (T(ps.csr_ptr(row, m)), T(col), T(val), T(ps.csr_ptr(col, n)),
             T(perm))
    got = pgf.gen_forward(conv, graph, T(x), T(x_dst))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    dx = pgf.gen_input_grad(conv, graph, T(x), T(x_dst))
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ mains
def lines(main, argv) -> list[dict]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


SPMM_PROBES = ["1. row gather", "1. gather_rows kernel", "2. window gather",
               "3. HBM transpose", "4. one-hot window contract",
               "5. blocked_spmm einsum traversal", "5. spmm_csr kernel",
               "5b. gather+mul msg build alone",
               "5c. one-hot dst contract alone", "6. dense bmm"]
GEN_PROBES = ["1. HBM stream read", "2. row gather", "2. gather_rows kernel",
              "3. sorted segment_max", "4a. sorted segment_sum",
              "4b. fused sorted segment_sum", "5. gather_src fwd+bwd",
              "6. GEN dir fwd (port)", "6. GEN dir fwd+bwd (port)",
              "7. gen_agg_fwd kernel", "7. gen_agg_bwd kernel"]


def check_rows(out: dict, names: list[str], n_rows: int):
    rows = out["probes"]
    assert len(rows) == n_rows
    for name in names:
        assert any(r["name"].startswith(name) for r in rows), name
    for r in rows:
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["bytes"] > 0
        assert r["share_of_bound"] is None     # the CPU: no device figure
        assert r["bound_by"] in ("bytes", "operations")
    assert out["device"] == "cpu"


def test_probe_spmm_main_prints_every_probe(monkeypatch):
    """At a tiny size through the module's shape constants."""
    for key, v in (("E", 4096), ("M", 512), ("N", 1024), ("D", 8),
                   ("TRANSPOSE_ROWS", 4)):
        monkeypatch.setattr(ps, key, v)
    (out,) = lines(ps.main, ["--device", "cpu"])
    check_rows(out, SPMM_PROBES, 13)
    calls = ps.N_WARM + ps.N_ITER
    assert out["launches"] == {"gather_rows": 2 * calls, "spmm_csr": calls}
    assert out["shapes"]["block_k"] == pick_block_k(4096, 512)
    four = next(r for r in out["probes"] if r["name"].startswith("4."))
    assert four["flops"] == 2.0 * 8 * 512 * 256 * 8


@pytest.mark.parametrize("only", ["", "gen"])
def test_probe_gen_floor_main_measures_every_floor(monkeypatch, only):
    """At a tiny size through the script's knobs; PROBE_ONLY=gen measures
    the floors too (no constant stands in for them)."""
    for key, v in (("PROBE_EDGES", "3000"), ("PROBE_CONS", "200"),
                   ("PROBE_VARS", "500"), ("PROBE_HIDS", "8"),
                   ("PROBE_ONLY", only)):
        monkeypatch.setenv(key, v)
    (out,) = lines(pgf.main, ["--device", "cpu"])
    check_rows(out, GEN_PROBES, 11)
    assert out["gen_modes"] == ["port"] and out["floors_measured"] is True
    assert out["probe_only"] == only
    calls = ps.N_WARM + ps.N_ITER
    assert out["launches"] == {"gather_rows": 2 * calls,
                               "spmm_csr": 2 * calls,
                               "gen_agg_fwd": 3 * calls + 1,
                               "gen_agg_bwd": 2 * calls}
    acc = out["accounting"]
    assert acc["need_fwd_bwd_ms"] > acc["need_fwd_ms"] > 0
    assert out["shapes"] == {"E": 3000, "M": 200, "N": 500, "D": 8,
                             "dtype": "bfloat16"}


def test_probe_knobs_default_to_the_scripts():
    assert pgf.knobs({}) == {"E": 1_000_000, "M": 65_536, "N": 131_072,
                             "D": 256, "only": ""}
    assert (ps.E, ps.M, ps.N, ps.D, ps.TRANSPOSE_ROWS) == (
        1_000_000, 65_536, 131_072, 256, 2048)
    assert ps.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):     # the shapes are fixed, as the script's
        ps.parse_args(["--edges", "4096"])
