"""Synthetic LP-family generators (counterpart of
``lp_gnn_tpu/data/generator.py``: one seed gives the same MPS bytes, and
``SIZES`` is the size table of ``scripts/generate_data.py:20``).

The reference trains on *families of similar LP instances* (mirp = maritime
inventory routing, readme.md:137; also small/medium, libsvm, miplib subsets —
utils.py:862-865). Those datasets are not part of the repo, so the
framework provides generators producing families with the same key property:
fixed structure per family, randomized data per instance, so the optimal
basis is learnable across instances.

Each generator takes two RNGs: ``rs`` draws *structure* (sparsity patterns,
networks, capacities — identical for every instance of a family) and ``rd``
draws *instance data* (costs, demands, rates — varying per instance).

Families
--------
- ``mirp_like``  multi-period, multi-port inventory+shipping LP: inventory
  balance equalities, arc capacities, port storage bounds. Equality-heavy,
  network-structured — the closest analog of the reference's mirp dataset.
- ``transport``  capacitated transportation problems (supply <=, demand >=).
- ``netflow``    min-cost flow on a random sparse digraph (balance equalities
  + arc capacities).
- ``packing``    random fractional packing LPs (one-sided <= rows).

``generate_dataset`` writes a family to ``{prefix}/{name}/mps/*.mps``
matching the pipeline layout (SURVEY.md §1).
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np
from scipy.sparse import coo_matrix

from ..io.mps import LPData, write_mps


def _names(prefix, k):
    return np.array([f"{prefix}{i}" for i in range(k)], dtype=object)


def gen_transport(rs, rd, m_src: int = 12, n_dst: int = 18) -> LPData:
    """Capacitated transportation LP: min sum c_ij x_ij,
    supply rows sum_j x_ij <= s_i, demand rows sum_i x_ij >= d_j,
    0 <= x_ij <= cap_ij (structure: which arcs are boxed)."""
    n = m_src * n_dst
    m = m_src + n_dst
    c = (rd.rand(n) * 10 + 1).round(3)
    demand = rd.rand(n_dst) * 10 + 5
    total_d = demand.sum()
    supply = rd.rand(m_src) + 1
    supply = supply / supply.sum() * total_d * (1.2 + 0.3 * rd.rand())
    rows, cols, vals = [], [], []
    for i in range(m_src):
        for j in range(n_dst):
            v = i * n_dst + j
            rows += [i, m_src + j]
            cols += [v, v]
            vals += [1.0, 1.0]
    A = coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    b_l = np.concatenate([np.full(m_src, -np.inf), demand])
    b_u = np.concatenate([supply, np.full(n_dst, np.inf)])
    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    boxed = rs.rand(n) < 0.3
    ub[boxed] = (rs.rand(int(boxed.sum())) * 5 + 2) * total_d / n_dst / m_src
    return LPData(c=c, b_l=b_l, A=A, b_u=b_u, lb=lb, ub=ub,
                  con_nms=_names("R", m), var_nms=_names("X", n),
                  name="transport")


def gen_mirp_like(rs, rd, n_ports: int = 6, n_periods: int = 10,
                  arc_density: float = 0.5, tightness: float = 1.0) -> LPData:
    """Multi-period inventory + shipping LP (mirp-style structure).

    Variables: inventory I_{p,t} (bounded storage), shipments x_{a,t}
    (capacitated arcs with travel time), spot purchases z_{p,t} and disposal
    w_{p,t} (both penalized — z covers shortfalls, w drains overflow so
    every instance is feasible). Rows: inventory balance equalities per
    (port, period), plus per-period fleet capacity rows (<=).
    """
    P, T = n_ports, n_periods
    arcs = [(p, q) for p in range(P) for q in range(P)
            if p != q and rs.rand() < arc_density]
    if not arcs:
        arcs = [(0, 1 % P)]
    A_ = len(arcs)
    travel = 1 + rs.randint(0, 2, A_)          # 1-2 period travel (structure)
    prod_ports = rs.rand(P) < 0.5
    if not prod_ports.any():
        prod_ports[0] = True
    if prod_ports.all():
        prod_ports[-1] = False
    # ``tightness`` < 1 shrinks every capacity, making more rows binding at
    # the optimum (longer simplex solves); > 1 relaxes them (gen_mirp_mix
    # uses this as one of its hardness axes)
    cap_store = (rs.rand(P) * 30 + 20) * tightness     # structure
    cap_arc = (rs.rand(A_) * 6 + 2) * tightness        # structure
    fleet_cap = A_ * (rs.rand() * 3 + 2) * tightness   # structure

    nI, nX, nZ = P * T, A_ * T, P * T
    nW = P * T
    n = nI + nX + nZ + nW

    def vI(p, t):
        return p * T + t

    def vX(a, t):
        return nI + a * T + t

    def vZ(p, t):
        return nI + nX + p * T + t

    def vW(p, t):
        return nI + nX + nZ + p * T + t

    m = P * T + T

    def rB(p, t):
        return p * T + t

    def rC(t):
        return P * T + t

    rate = np.where(prod_ports, rd.rand(P) * 4 + 2, -(rd.rand(P) * 4 + 2))
    r = rate[:, None] * (0.8 + 0.4 * rd.rand(P, T))

    rows, cols, vals = [], [], []
    for p in range(P):
        for t in range(T):
            i = rB(p, t)
            rows += [i, i, i]
            cols += [vI(p, t), vZ(p, t), vW(p, t)]
            vals += [1.0, -1.0, 1.0]
            if t > 0:
                rows.append(i)
                cols.append(vI(p, t - 1))
                vals.append(-1.0)
    for a, (p, q) in enumerate(arcs):
        for t in range(T):
            rows.append(rB(p, t))
            cols.append(vX(a, t))
            vals.append(1.0)
            if t + travel[a] < T:
                rows.append(rB(q, t + int(travel[a])))
                cols.append(vX(a, t))
                vals.append(-1.0)
            rows.append(rC(t))
            cols.append(vX(a, t))
            vals.append(1.0)

    A = coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    rhs = np.concatenate([r.reshape(-1), np.zeros(T)])
    b_l = rhs.copy()
    b_u = rhs.copy()
    b_l[P * T:] = -np.inf
    b_u[P * T:] = fleet_cap

    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    for p in range(P):
        ub[vI(p, 0): vI(p, 0) + T] = cap_store[p]
    for a in range(A_):
        ub[vX(a, 0): vX(a, 0) + T] = cap_arc[a]

    c = np.zeros(n)
    c[:nI] = 0.1 + 0.2 * rd.rand(nI)                       # holding cost
    c[nI:nI + nX] = np.repeat(rd.rand(A_) * 3 + 1, T)      # shipping cost
    c[nI + nX:nI + nX + nZ] = 50.0 + 10 * rd.rand(nZ)      # spot penalty
    c[nI + nX + nZ:] = 40.0 + 10 * rd.rand(nW)             # disposal penalty
    return LPData(c=c, b_l=b_l, A=A, b_u=b_u, lb=lb, ub=ub,
                  con_nms=_names("R", m), var_nms=_names("X", n),
                  name="mirp_like")


def gen_mirp_mix(rs, rd, n_ports_range=(22, 40), n_periods_range=(45, 110),
                 arc_density_range=(0.22, 0.38),
                 tightness_range=(0.75, 1.25)) -> LPData:
    """Hardness-mixed mirp family: the reference's real MIRPLIB Group-1
    population is NOT a fixed-size family — its cold-solve iteration counts
    spread 29.9K ± 17.0K (CoV 0.57, reference readme.md:139) because
    instances differ in port count, horizon, and bound tightness. This
    generator reproduces that regime within ONE family: every instance
    draws its own (n_ports, n_periods, arc_density, tightness) from ``rd``
    and its own network structure from an rd-derived structure RNG, so the
    cold-solve hardness varies by multiples across the family while the
    problem *class* (inventory-balance + shipping + capacity structure)
    stays fixed — the property that makes the optimal basis learnable
    across instances (readme.md:137-143 regime).
    Default ranges calibrated on HiGHS 1.8 cold solves (seed 0, 8 probe
    instances): mean 23.5K ± 16.6K iterations, CoV 0.71 — the reference
    population's 29.9K ± 17.0K / CoV 0.57 regime."""
    lo_p, hi_p = n_ports_range
    lo_t, hi_t = n_periods_range
    P = int(rd.randint(lo_p, hi_p + 1))
    T = int(rd.randint(lo_t, hi_t + 1))
    dens = arc_density_range[0] + \
        (arc_density_range[1] - arc_density_range[0]) * rd.rand()
    tight = tightness_range[0] + \
        (tightness_range[1] - tightness_range[0]) * rd.rand()
    # per-instance structure (like the real population: each instance is its
    # own port/horizon configuration), deterministic in (seed, instance)
    rs_inst = np.random.RandomState(
        (rs.randint(1 << 30) * 2654435761 + rd.randint(1 << 30)) % (1 << 31))
    lp = gen_mirp_like(rs_inst, rd, n_ports=P, n_periods=T,
                       arc_density=dens, tightness=tight)
    return LPData(c=lp.c, b_l=lp.b_l, A=lp.A, b_u=lp.b_u, lb=lp.lb,
                  ub=lp.ub, con_nms=lp.con_nms, var_nms=lp.var_nms,
                  name="mirp_mix")


def gen_mirp_mix_shared(rs, rd, n_ports: int = 30,
                        n_periods_range=(30, 160), arc_density: float = 0.3,
                        tightness_range=(0.6, 1.4)) -> LPData:
    """Hardness-mixed mirp with SHARED structure: ONE port network for the
    whole family (drawn from ``rs`` like gen_mirp_like), with only the
    horizon length and the bound tightness drawn per instance — so
    cold-solve hardness spreads like the real population while every
    instance is the *same* logistics system observed over different
    horizons under different capacity regimes. This isolates the two
    variables gen_mirp_mix confounds: the full mix also redraws the
    network per instance, and its run showed that *structural*
    heterogeneity (not hardness spread) is what collapses warm-start
    quality (+12.7% vs the fixed family's +39%, RESULTS.md) — the real
    MIRPLIB Group-1 instances share port geography the way this variant
    does, which is the regime of the reference's published 1.72x.
    Default ranges calibrated on HiGHS 1.8 cold solves (seed 0, 8 probes):
    18.5K ± 11.0K iterations, CoV 0.60."""
    lo_t, hi_t = n_periods_range
    T = int(rd.randint(lo_t, hi_t + 1))
    tight = tightness_range[0] + \
        (tightness_range[1] - tightness_range[0]) * rd.rand()
    # same structure stream for every instance of the family: gen_mirp_like
    # consumes rs identically given fixed (n_ports, arc_density)
    rs_fixed = np.random.RandomState(rs.randint(1 << 30))
    lp = gen_mirp_like(rs_fixed, rd, n_ports=n_ports, n_periods=T,
                       arc_density=arc_density, tightness=tight)
    return LPData(c=lp.c, b_l=lp.b_l, A=lp.A, b_u=lp.b_u, lb=lp.lb,
                  ub=lp.ub, con_nms=lp.con_nms, var_nms=lp.var_nms,
                  name="mirp_mix_s")


def _quantize(x, levels, lo, hi):
    """Snap continuous draws onto ``levels`` evenly spaced values in
    [lo, hi] — exact cost ties are what create dual degeneracy (many
    nonbasic columns with zero reduced cost at the optimum)."""
    if levels <= 1:
        return np.full_like(x, (lo + hi) / 2.0)
    g = np.round((np.asarray(x, np.float64) - lo) / (hi - lo) * (levels - 1))
    return lo + g * (hi - lo) / (levels - 1)


def gen_mirp_degen(rs, rd, n_ports: int = 30, n_periods: int = 60,
                   arc_density: float = 0.3, tightness: float = 1.0,
                   degeneracy: float = 0.5) -> LPData:
    """mirp_like with a controlled DUAL-DEGENERACY level (the last standing
    hypothesis for the 1.6x-vs-published-1.72x headline gap is that real
    MIRPLIB LPs are far more dual-degenerate — many optimal bases, so imperfect predictions still land near an
    optimal face; readme.md:137-143 is the published number).

    Two independent mechanisms, both scaled by ``degeneracy`` in [0, 1],
    at FIXED structure knobs (the bench-tier 30x60 configuration, so
    hardness stays comparable to mirp_bench):

    1. **Cost quantization**: the continuous holding / shipping / penalty
       cost draws are snapped onto a coarse grid (13 levels at 0 down to a
       single value at 1). Tied costs make alternative optima exact.
    2. **Arc duplication**: a ``degeneracy`` fraction of shipping arcs is
       cloned — identical column pattern, identical cost, capacity split
       in half between the twins — so ANY split of flow between a twin
       pair is optimal (textbook massive dual degeneracy, structure-
       preserving: total arc capacity is unchanged).
    """
    lp = gen_mirp_like(rs, rd, n_ports=n_ports, n_periods=n_periods,
                       arc_density=arc_density, tightness=tightness)
    P, T = n_ports, n_periods
    n = lp.c.shape[0]
    nI = P * T
    nX = n - 3 * P * T
    A_ = nX // T
    c = lp.c.copy()
    levels = max(1, int(round((1.0 - degeneracy) * 12)) + 1)
    c[:nI] = _quantize(c[:nI], levels, 0.1, 0.3)
    # shipping costs are per-arc constants repeated over T: quantize the
    # per-arc values so twins/parallel routes tie exactly
    ship = c[nI:nI + nX].reshape(A_, T)
    ship[:] = _quantize(ship[:, :1], levels, 1.0, 4.0)
    c[nI + nX:nI + nX + P * T] = _quantize(
        c[nI + nX:nI + nX + P * T], levels, 50.0, 60.0)
    c[nI + nX + P * T:] = _quantize(c[nI + nX + P * T:], levels, 40.0, 50.0)
    n_dup = int(round(degeneracy * A_))
    if n_dup == 0:
        return LPData(c=c, b_l=lp.b_l, A=lp.A, b_u=lp.b_u, lb=lp.lb,
                      ub=lp.ub, con_nms=lp.con_nms, var_nms=lp.var_nms,
                      name="mirp_degen")
    from scipy.sparse import hstack
    dup_arcs = rs.choice(A_, size=n_dup, replace=False)
    cols = (nI + dup_arcs[:, None] * T + np.arange(T)[None, :]).reshape(-1)
    ub = lp.ub.copy()
    ub[cols] = ub[cols] / 2.0
    A = hstack([lp.A.tocsc(), lp.A.tocsc()[:, cols]]).tocsr()
    c_new = np.concatenate([c, c[cols]])
    lb_new = np.concatenate([lp.lb, lp.lb[cols]])
    ub_new = np.concatenate([ub, ub[cols]])
    n_new = n + len(cols)
    return LPData(c=c_new, b_l=lp.b_l, A=A, b_u=lp.b_u, lb=lb_new,
                  ub=ub_new, con_nms=lp.con_nms,
                  var_nms=_names("X", n_new), name="mirp_degen")


def gen_netflow(rs, rd, n_nodes: int = 40, density: float = 0.15) -> LPData:
    """Min-cost flow with supplies/demands, arc capacities, and heavily
    penalized per-node surplus/deficit slacks (so sparse or disconnected
    networks stay feasible)."""
    N = n_nodes
    arcs = [(i, j) for i in range(N) for j in range(N)
            if i != j and rs.rand() < density]
    na = len(arcs)
    n = na + 2 * N      # arcs + (surplus, deficit) per node
    supply = rd.randn(N) * 5
    supply -= supply.mean()
    rows, cols, vals = [], [], []
    for a, (i, j) in enumerate(arcs):
        rows += [i, j]
        cols += [a, a]
        vals += [1.0, -1.0]
    for i in range(N):
        rows += [i, i]
        cols += [na + i, na + N + i]
        vals += [1.0, -1.0]
    A = coo_matrix((vals, (rows, cols)), shape=(N, n)).tocsr()
    c = np.concatenate([rd.rand(na) * 10 + 0.5,
                        np.full(2 * N, 500.0 + 100 * rd.rand())])
    ub = np.concatenate([rs.rand(na) * 20 + 5, np.full(2 * N, np.inf)])
    return LPData(c=c, b_l=supply.copy(), A=A, b_u=supply.copy(),
                  lb=np.zeros(n), ub=ub,
                  con_nms=_names("R", N), var_nms=_names("X", n),
                  name="netflow")


def gen_packing(rs, rd, m: int = 40, n: int = 80, density: float = 0.2) -> LPData:
    """Random fractional packing LP: min -p.x s.t. Ax <= b, 0<=x<=1."""
    mask = rs.rand(m, n) < density
    for i in range(m):
        if not mask[i].any():
            mask[i, rs.randint(n)] = True
    for j in range(n):
        if not mask[:, j].any():
            mask[rs.randint(m), j] = True
    r, cc = np.nonzero(mask)
    vals = rd.rand(mask.sum()) * 4 + 1
    A = coo_matrix((vals, (r, cc)), shape=(m, n)).tocsr()
    b = np.asarray(A.sum(axis=1)).flatten() * (0.3 + 0.2 * rd.rand(m))
    c = -(rd.rand(n) * 9 + 1)
    return LPData(c=c, b_l=np.full(m, -np.inf), A=A, b_u=b,
                  lb=np.zeros(n), ub=np.ones(n),
                  con_nms=_names("R", m), var_nms=_names("X", n),
                  name="packing")


def gen_stoch(rs, rd, n_first: int = 10, n_scen: int = 8,
              m_scen: int = 12) -> LPData:
    """Two-stage stochastic LP (block-angular), the analog of the
    reference's stoch-sc/el datasets (utils.py:862-865; val.py:211-213
    treats 'stoch' constraint labels specially).

    min c.x + sum_s p_s q.y_s ; per scenario: A1 x + W y_s >= d_s ;
    0 <= x <= u, y_s >= 0.
    """
    n1 = n_first
    ny = m_scen           # one recourse var per scenario row (W = I)
    n = n1 + n_scen * ny
    m = n_scen * m_scen
    A1_mask = rs.rand(m_scen, n1) < 0.4
    for i in range(m_scen):
        if not A1_mask[i].any():
            A1_mask[i, rs.randint(n1)] = True
    A1_vals = rs.rand(int(A1_mask.sum())) * 2 + 0.5   # structure-fixed
    rows, cols, vals = [], [], []
    r_, c_ = np.nonzero(A1_mask)
    for s in range(n_scen):
        base = s * m_scen
        for rr, cc, vv in zip(r_, c_, A1_vals):
            rows.append(base + rr)
            cols.append(cc)
            vals.append(vv)
        for i in range(m_scen):
            rows.append(base + i)
            cols.append(n1 + s * ny + i)
            vals.append(1.0)
    A = coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    d = rd.rand(m) * 8 + 2
    c = np.concatenate([rd.rand(n1) * 5 + 1,
                        np.tile(rd.rand(ny) * 20 + 10, n_scen) / n_scen])
    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    ub[:n1] = rs.rand(n1) * 20 + 5
    return LPData(c=c, b_l=d, A=A, b_u=np.full(m, np.inf),
                  lb=lb, ub=ub,
                  con_nms=_names("R", m), var_nms=_names("X", n),
                  name="stoch")


def gen_svm(rs, rd, m_samples: int = 60, n_features: int = 20,
            density: float = 0.5, C: float = 0.1) -> LPData:
    """L1-regularized soft-margin linear SVM as an LP — the analog of the
    reference's libsvm_6 datasets (utils.py:862-865: LPs with one constraint
    per data sample).

    min sum_i xi_i + C * sum_j (w+_j + w-_j)
    s.t. y_i (a_i.(w+ - w-) + b) + xi_i >= 1 ;  xi, w+, w- >= 0 ;  b free.

    Structure (``rs``): the feature sparsity pattern and class centroids.
    Data (``rd``): the sampled points around those centroids.
    """
    ms, nf = m_samples, n_features
    centroid = rs.randn(2, nf) * 1.5                 # structure
    feat_mask = rs.rand(ms, nf) < density            # structure
    for i in range(ms):
        if not feat_mask[i].any():
            feat_mask[i, rs.randint(nf)] = True
    y = np.where(np.arange(ms) % 2 == 0, 1.0, -1.0)
    pts = centroid[(y < 0).astype(int)] + rd.randn(ms, nf)
    X = np.where(feat_mask, pts, 0.0)

    # vars: [xi (ms), w+ (nf), w- (nf), b+ , b-]   (b split to stay >= 0)
    n = ms + 2 * nf + 2
    rows, cols, vals = [], [], []
    for i in range(ms):
        rows.append(i)
        cols.append(i)
        vals.append(1.0)                              # xi_i
        for j in np.nonzero(feat_mask[i])[0]:
            v = float(y[i] * X[i, j])
            if v != 0.0:
                rows += [i, i]
                cols += [ms + j, ms + nf + j]
                vals += [v, -v]                       # w+_j, w-_j
        rows += [i, i]
        cols += [ms + 2 * nf, ms + 2 * nf + 1]
        vals += [float(y[i]), -float(y[i])]           # b+ - b-
    A = coo_matrix((vals, (rows, cols)), shape=(ms, n)).tocsr()
    c = np.concatenate([np.ones(ms), np.full(2 * nf, C), np.zeros(2)])
    return LPData(c=c, b_l=np.ones(ms), A=A, b_u=np.full(ms, np.inf),
                  lb=np.zeros(n), ub=np.full(n, np.inf),
                  con_nms=_names("R", ms), var_nms=_names("X", n),
                  name="svm")


def gen_miplib_like(rs, rd, n_items: int = 30, n_bins: int = 8,
                    n_knap: int = 10, n_cover: int = 10,
                    density: float = 0.25) -> LPData:
    """Heterogeneous-structure LP: the relaxation of an assignment +
    knapsack + set-cover MIP — the analog of the reference's miplib_8
    datasets (utils.py:862-865: LP relaxations of MIPLIB instances, mixed
    row types instead of one clean family structure).

    Rows: assignment equalities (sum_b x_{i,b} = 1 per item), bin capacity
    knapsacks (<=), and set-cover rows over side variables (>=).
    Vars: x_{i,b} in [0,1] (relaxed binaries) + continuous cover vars.
    """
    nI, nB = n_items, n_bins
    nx = nI * nB
    n_side = max(n_cover * 3, 12)
    n = nx + n_side
    m = nI + nB + n_knap + n_cover
    rows, cols, vals = [], [], []
    # assignment equalities
    for i in range(nI):
        for b in range(nB):
            rows.append(i)
            cols.append(i * nB + b)
            vals.append(1.0)
    # bin capacity knapsacks: sum_i w_i x_{i,b} <= cap_b
    w = rs.rand(nI) * 4 + 1                      # structure
    for b in range(nB):
        for i in range(nI):
            rows.append(nI + b)
            cols.append(i * nB + b)
            vals.append(float(w[i]))
    # extra random knapsack rows over side vars + some x vars
    for k in range(n_knap):
        sub = np.nonzero(rs.rand(n) < density)[0]
        if len(sub) == 0:
            sub = np.array([rs.randint(n)])
        for j in sub:
            rows.append(nI + nB + k)
            cols.append(int(j))
            vals.append(float(rs.rand() * 3 + 0.5))
    # set-cover rows: sum over a random subset of side vars >= 1
    for k in range(n_cover):
        sub = nx + np.nonzero(rs.rand(n_side) < 0.4)[0]
        if len(sub) == 0:
            sub = np.array([nx + rs.randint(n_side)])
        for j in sub:
            rows.append(nI + nB + n_knap + k)
            cols.append(int(j))
            vals.append(1.0)
    A = coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    cap = np.asarray(A[nI:nI + nB].sum(axis=1)).flatten() \
        * (0.25 + 0.15 * rd.rand(nB)) + w.max()
    kcap = np.asarray(A[nI + nB:nI + nB + n_knap].sum(axis=1)).flatten() \
        * (0.4 + 0.3 * rd.rand(n_knap))
    b_l = np.concatenate([np.ones(nI), np.full(nB + n_knap, -np.inf),
                          np.ones(n_cover)])
    b_u = np.concatenate([np.ones(nI), cap, kcap, np.full(n_cover, np.inf)])
    c = np.concatenate([rd.rand(nx) * 10 + 1, rd.rand(n_side) * 5 + 0.5])
    ub = np.concatenate([np.ones(nx), np.full(n_side, np.inf)])
    return LPData(c=c, b_l=b_l, A=A, b_u=b_u, lb=np.zeros(n), ub=ub,
                  con_nms=_names("R", m), var_nms=_names("X", n),
                  name="miplib_like")


def permute_instance(lp: LPData, rng) -> LPData:
    """Random row/column relabeling of one instance — the analog of the
    reference's ``-perm`` dataset variants (utils.py:862-865): the same LP
    family presented under per-instance permutations, so the model must be
    permutation-equivariant rather than position-keyed."""
    m, n = lp.A.shape
    rp, cp = rng.permutation(m), rng.permutation(n)
    A = lp.A.tocsr()[rp][:, cp].tocsr()
    return LPData(c=lp.c[cp], b_l=lp.b_l[rp], A=A, b_u=lp.b_u[rp],
                  lb=lp.lb[cp], ub=lp.ub[cp],
                  con_nms=lp.con_nms[rp], var_nms=lp.var_nms[cp],
                  name=lp.name + "-perm")


GENERATORS = {
    "mirp_like": gen_mirp_like,
    "mirp_mix": gen_mirp_mix,
    "mirp_mix_s": gen_mirp_mix_shared,
    "mirp_degen": gen_mirp_degen,
    "transport": gen_transport,
    "netflow": gen_netflow,
    "packing": gen_packing,
    "stoch": gen_stoch,
    "svm": gen_svm,
    "miplib_like": gen_miplib_like,
}


def generate_instance(family: str, seed: int, instance: int, perm: bool = False,
                      **kwargs) -> LPData:
    """One instance: structure fixed by ``seed``, data varies by ``instance``.
    ``perm=True`` additionally relabels rows/cols per instance (reference's
    ``-perm`` dataset variants)."""
    rs = np.random.RandomState(seed)
    rd = np.random.RandomState(seed * 100003 + instance + 1)
    lp = GENERATORS[family](rs, rd, **kwargs)
    if perm:
        lp = permute_instance(lp, np.random.RandomState(seed * 7919 + instance))
    return lp


def generate_dataset(name: str, out_prefix: str, n_instances: int = 40,
                     seed: int = 0, family: str | None = None,
                     **kwargs) -> list[str]:
    """Write a family to ``{out_prefix}/{name}/mps/*.mps``
    (pipeline layout, SURVEY.md §1)."""
    family = family or name.split("-")[0]
    # "-perm" dataset-name suffix => per-instance row/col relabeling
    # (reference's medium-perm variants, utils.py:862-865)
    kwargs.setdefault("perm", name.endswith("-perm"))
    mps_dir = osp.join(out_prefix, name, "mps")
    os.makedirs(mps_dir, exist_ok=True)
    out = []
    for k in range(n_instances):
        lp = generate_instance(family, seed, k, **kwargs)
        fn = osp.join(mps_dir, f"{family}_{k}.mps")
        write_mps(lp, fn)
        out.append(fn)
    return out


#: per family, the generator's keyword arguments for each size tier
#: (``--size``), as scripts/generate_data.py:20 has them
SIZES = {
    # family -> kwargs per size tier
    "mirp_like": {
        "small": dict(n_ports=4, n_periods=6),
        "demo": dict(n_ports=15, n_periods=30, arc_density=0.4),
        "bench": dict(n_ports=30, n_periods=60, arc_density=0.3),
    },
    "mirp_mix": {
        # hardness-mixed family: per-instance draws of
        # ports/periods/density/tightness — ranges ARE the size knobs
        "small": dict(n_ports_range=(3, 6), n_periods_range=(4, 10),
                      arc_density_range=(0.4, 0.6),
                      tightness_range=(0.8, 1.2)),
        "demo": dict(n_ports_range=(10, 20), n_periods_range=(15, 45),
                     arc_density_range=(0.3, 0.5),
                     tightness_range=(0.8, 1.2)),
        "bench": dict(),   # generator defaults: the reference-population mix
    },
    "mirp_degen": {
        # degeneracy-controlled mirp: bench-tier
        # structure fixed to the mirp_bench knobs, the dataset *name*
        # selects the dual-degeneracy level
        "small": dict(n_ports=4, n_periods=6, degeneracy=0.5),
        "bench_d3": dict(n_ports=30, n_periods=60, arc_density=0.3,
                         degeneracy=0.3),
        "bench_d6": dict(n_ports=30, n_periods=60, arc_density=0.3,
                         degeneracy=0.6),
        "bench_d9": dict(n_ports=30, n_periods=60, arc_density=0.3,
                         degeneracy=0.9),
    },
    "transport": {
        "small": dict(m_src=6, n_dst=9),
        "demo": dict(m_src=40, n_dst=60),
        "bench": dict(m_src=120, n_dst=200),
    },
    "netflow": {
        "small": dict(n_nodes=20, density=0.2),
        "demo": dict(n_nodes=150, density=0.08),
        "bench": dict(n_nodes=600, density=0.02),
    },
    "packing": {
        "small": dict(m=20, n=40),
        "demo": dict(m=200, n=400),
        "bench": dict(m=800, n=1600),
    },
    "stoch": {
        "small": dict(n_first=6, n_scen=4, m_scen=8),
        "demo": dict(n_first=30, n_scen=25, m_scen=40),
        "bench": dict(n_first=60, n_scen=60, m_scen=60),
    },
    "svm": {
        "small": dict(m_samples=40, n_features=12),
        "demo": dict(m_samples=300, n_features=60),
        "bench": dict(m_samples=1500, n_features=200),
    },
    "miplib_like": {
        "small": dict(n_items=12, n_bins=4, n_knap=5, n_cover=5),
        "demo": dict(n_items=60, n_bins=12, n_knap=30, n_cover=30),
        "bench": dict(n_items=200, n_bins=25, n_knap=120, n_cover=120,
                      density=0.1),
    },
}
