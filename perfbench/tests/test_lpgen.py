"""The traffic generator: its frozen copies of the mirp family's
generator and of prep's processing against the program's originals, and
the mirp traffic's LPs (``traffic/mirp28.json``, no cell yet) alike in
work from seed to seed."""
from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench import lpgen, manifest, mirp


@pytest.mark.parametrize("size", ["small", "demo", "bench"])
def test_mirp_is_the_programs_lp(size):
    from lp_gnn_tpu_torch.data import features, generator, scaling

    kw = dict(arc_density=0.5, tightness=1.0)
    kw.update(generator.SIZES["mirp_like"][size])
    for seed, instance in ((0, 3), (7, 0)):
        lp = generator.generate_instance("mirp_like", seed, instance, **kw)
        data = np.random.RandomState(seed * 100003 + instance + 1)
        got = mirp.generate(np.random.RandomState(seed), data, **kw)
        want = (lp.c, lp.b_l, lp.A, lp.b_u, lp.lb, lp.ub)
        assert (got[2] != want[2]).nnz == 0
        for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
            np.testing.assert_array_equal(a, b)
        a, v_feas, c_feas = mirp.prepare(*got)
        c, b_l, A, b_u, l, u = scaling.scaling(*(np.copy(x) if not hasattr(
            x, "tocsr") else x.copy() for x in want))
        v_want, c_want = features.cvt_to_features(c, b_l, A, b_u, l, u)
        ac = A.tocoo()
        np.testing.assert_array_equal(a.row, ac.row)
        np.testing.assert_array_equal(a.col, ac.col)
        np.testing.assert_allclose(a.data, ac.data, rtol=1e-15)
        np.testing.assert_allclose(v_feas, v_want.astype(np.float32),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(c_feas, c_want.astype(np.float32),
                                   rtol=1e-6, atol=1e-7)


def test_mirp28_is_the_recipes_shape_on_every_seed():
    traffic = json.loads((manifest.HERE / "traffic" / "mirp28.json")
                         .read_text())
    seen = []
    for seed in (0, 2 ** 31 + 5):
        lp = lpgen.draw_lp(traffic, seed, 1)
        assert (lp.ncons, lp.nvars, lp.nnz) == (1860, 21780, 55902)
        assert np.abs(lp.val).max() <= 1 + 1e-6
        for y, feas in ((lp.y_s, lp.c_feas), (lp.y_t, lp.v_feas)):
            assert not (y[feas[:, -3] != 0] == 0).any()
            assert not (y[feas[:, -1] != 0] == 2).any()
            assert set(np.unique(y)) <= {0, 1, 2}
        seen.append(lp)
    # the same structure, other data
    np.testing.assert_array_equal(seen[0].col, seen[1].col)
    assert not np.array_equal(seen[0].v_feas, seen[1].v_feas)


def test_labels_take_each_allowed_status():
    rng = np.random.default_rng(0)
    feas = np.zeros((3000, 8), np.float32)
    feas[1000:2000, -3] = -1    # no lower bound: 1 or 2
    feas[2000:, -1] = 1         # no upper bound: 0 or 1
    y = lpgen._labels(rng, feas)
    assert set(np.unique(y[:1000])) == {0, 1, 2}
    assert set(np.unique(y[1000:2000])) == {1, 2}
    assert set(np.unique(y[2000:])) == {0, 1}
