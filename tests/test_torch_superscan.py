"""tpusparse_torch superscan against the JAX package, on the CPU: the
copied planner bit for bit, the factor from the same initial pools, the
solve on the same factor, the contracts, and the cholsol entry point.
Inputs are made with numpy seeds and handed to both packages."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.core import CSCMatrix, csc_from_dense
from tpusparse.device import superscan as jss
from tpusparse.device.supernodal import _column_patterns as jax_colpat
import tpusparse_torch
from tpusparse_torch.device import superscan as tss
from tpusparse_torch.device import superscan_plan as tsp
from tpusparse_torch.core import CSCMatrix as TCSC
from tpusparse_torch.demo import w_on_column
from tpusparse_torch.device.patterns import _column_patterns
from tpusparse_torch.utils.profiling import recording, span
from helpers import resid


def _port(A):
    """The port's CSCMatrix from the arrays of the JAX package's: the
    port is never handed a JAX-package object."""
    return TCSC(A.m, A.n, A.indptr, A.indices, A.data)


def _spd(rng, n, dens=0.25):
    d = rng.normal(size=(n, n)) * (rng.random((n, n)) < dens)
    d = d @ d.T + n * np.eye(n)
    return d, csc_from_dense(d)


def _band(rng, n=400):
    d = np.zeros((n, n))
    for k in range(4):
        v = rng.normal(size=n - k)
        d[np.arange(n - k), np.arange(k, n)] += v
        d[np.arange(k, n), np.arange(n - k)] += v
    d = d @ d.T + 10 * n * np.eye(n)
    return d, csc_from_dense(d)


def _grid3d(g):
    n = g ** 3
    ex = -np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0
    ey = -np.ones(n - g)
    ey[((np.arange(g, n) // g) % g) == 0] = 0
    ez = -np.ones(n - g * g)
    S = sp.diags([7.0 * np.ones(n), ex, ex, ey, ey, ez, ez],
                 [0, 1, -1, g, -g, g * g, -g * g], format="csc")
    S.sort_indices()
    return CSCMatrix(n, n, S.indptr, S.indices, S.data)


def _grid_case(g):
    A = _grid3d(g)
    return sp.csc_matrix((A.data, A.indices, A.indptr),
                         shape=(A.n, A.n)).toarray(), A


SMALL = dict(wmax=16, tau=0.9, small_w=4)
# name -> (matrix maker, planner kwargs, environment); the matrices of
# tests/test_superscan.py under the settings its tests use
CASES = {
    **{f"spd{n}_o{o}": (lambda rng, n=n, dd=dd: _spd(rng, n, dd),
                        dict(order=o, **SMALL), {})
       for n, dd in ((25, 0.5), (90, 0.15), (180, 0.05)) for o in (0, 1)},
    "band": (_band, dict(order=0, max_segments=6, **SMALL), {}),
    "seg_cluster": (lambda rng: _spd(rng, 220, 0.05),
                    dict(order=1, max_segments=12, **SMALL),
                    {"TPUSPARSE_SEG_MODE": "cluster"}),
    "seg_dp": (lambda rng: _spd(rng, 220, 0.05),
               dict(order=1, max_segments=12, **SMALL),
               {"TPUSPARSE_SEG_MODE": "dp"}),
    "switch0": (lambda rng: _spd(rng, 150, 0.08),
                dict(order=1, wmax=16, small_w=4),
                {"TPUSPARSE_SWITCH": "0"}),
    "switch1": (lambda rng: _spd(rng, 150, 0.08),
                dict(order=1, wmax=16, small_w=4),
                {"TPUSPARSE_SWITCH": "1",
                 "TPUSPARSE_SWITCH_MIN_FLOPS": "0"}),
    # test_aggregated_update_path's matrices: the updg/upda phases
    **{f"agg{n}": (lambda rng, n=n, dd=dd: _spd(rng, n, dd),
                   dict(order=1, **SMALL), {"TPUSPARSE_AGG": "1"})
       for n, dd in ((40, 0.3), (90, 0.12))},
    # a lowered TPUSPARSE_AGG_MMAX keeps the panels over 16 od rows per
    # pair: all six phase kinds, per-pair and aggregated updates in the
    # same steps (as in the g=48 aggregated plan at the default 1,024)
    "agg_mixed": (lambda rng: _grid_case(6), dict(order=1),
                  {"TPUSPARSE_AGG": "1", "TPUSPARSE_AGG_MMAX": "16"}),
}
# the factor/solve parity cases (each costs a JAX compile of its own)
FACTOR_CASES = ["spd25_o0", "spd90_o1", "spd180_o1", "band", "seg_dp",
                "switch1", "agg40", "agg90", "agg_mixed"]


def _setup(name, rng, monkeypatch):
    build, kw, env = CASES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    d, A = build(rng)
    return d, A, kw


def _steps(xs_list):
    return sum(next(iter(next(iter(xs.values())).values())).shape[0]
               for xs in xs_list if xs)


def _assert_plans_equal(p, q, monkeypatch):
    """Port plan ``p`` against JAX plan ``q``, bit for bit.  The solve
    schedules differ by design: the port's ``_solve_xs`` has no slot cap,
    so it is held against the JAX one under TPUSPARSE_SOLVE_SLOT_CAP=0,
    the schedule the port executes."""
    for f in ("n", "nlevels", "nsteps", "flops_true", "flops_padded",
              "lnz", "slots_used", "slots_issued"):
        assert getattr(p, f) == getattr(q, f), f
    assert np.array_equal(p.perm, q.perm)
    assert p.pool_rows == q.pool_rows
    assert sorted(p.pool_init) == sorted(q.pool_init)
    for pw in p.pool_init:
        assert np.array_equal(p.pool_init[pw], q.pool_init[pw])
    assert len(p.panels) == len(q.panels)
    for a, b in zip(p.panels, q.panels):
        assert (a.pid, a.c0, a.w, a.W, a.pool, a.rbase, a.rlen, a.level) \
            == (b.pid, b.c0, b.w, b.W, b.pool, b.rbase, b.rlen, b.level)
        assert np.array_equal(a.rows, b.rows)
    assert len(p.segments) == len(q.segments)
    for s, t in zip(p.segments, q.segments):
        assert (s.lo, s.hi, s.scratch_rows) == (t.lo, t.hi, t.scratch_rows)
        assert s.ladders == t.ladders
        assert sorted(s.lvls) == sorted(t.lvls)
        for k in s.lvls:
            assert np.array_equal(s.lvls[k], t.lvls[k])
        assert sorted(s.xs) == sorted(t.xs)
        for k in s.xs:
            assert sorted(s.xs[k]) == sorted(t.xs[k])
            for nm in s.xs[k]:
                assert s.xs[k][nm].dtype == t.xs[k][nm].dtype
                assert np.array_equal(s.xs[k][nm], t.xs[k][nm])
    sx = tsp._solve_xs(p)
    with monkeypatch.context() as m:
        m.setenv("TPUSPARSE_SOLVE_SLOT_CAP", "0")
        tx = jss._solve_xs(q)
    assert len(sx) == len(tx)
    for s, t in zip(sx, tx):
        assert sorted(s) == sorted(t)
        for k in s:
            assert sorted(s[k]) == sorted(t[k])
            for nm in s[k]:
                assert np.array_equal(s[k][nm], t[k][nm])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_parity(rng, monkeypatch, name):
    d, A, kw = _setup(name, rng, monkeypatch)
    _assert_plans_equal(tsp.plan_superscan(_port(A), **kw),
                        jss.plan_superscan(A, **kw), monkeypatch)


def test_plan_parity_canonical_grid(monkeypatch):
    """The canonical 3D Laplacian g=24: the plan fields of BENCH_r05."""
    A = _grid3d(24)
    p = tsp.plan_superscan(_port(A), order=1)
    _assert_plans_equal(p, jss.plan_superscan(A, order=1), monkeypatch)
    assert (p.n, A.indptr[-1], p.lnz, p.flops_true, p.flops_padded) == (
        13824, 93312, 1874559, 969172461, 1607240757)
    assert round(p.waste_ratio, 4) == 0.397
    assert round(p.slot_occupancy, 4) == 0.9968


def test_plan_parity_canonical_grid_aggregated(monkeypatch):
    """The canonical grid under TPUSPARSE_AGG=1: the plan equal to JAX's,
    with the fields that chip_smoke.py's phase 19 asserts, and the pool
    layout of the per-pair plan (the update schedule does not move a
    row)."""
    A = _grid3d(24)
    base = tsp.plan_superscan(_port(A), order=1)
    monkeypatch.setenv("TPUSPARSE_AGG", "1")
    p = tsp.plan_superscan(_port(A), order=1)
    _assert_plans_equal(p, jss.plan_superscan(A, order=1), monkeypatch)
    assert (p.flops_padded, len(p.segments), p.nsteps) == (
        4368840232, 10, 120)
    assert max(s.scratch_rows for s in p.segments) == 4960
    assert {k[0] for s in p.segments for k in s.xs} == {
        "updg", "upda", "chol", "trsm"}
    assert p.pool_rows == base.pool_rows
    for pw in p.pool_init:
        assert np.array_equal(p.pool_init[pw], base.pool_init[pw])


def test_pattern_copies_match(rng):
    from tpusparse.core.ops import symperm
    from tpusparse.symbolic.etree import counts, etree, post
    _, A = _spd(rng, 120, 0.08)
    Cu = symperm(A, np.arange(A.n), values=False)
    parent = etree(Cu)
    cnt = counts(Cu, parent, post(parent))
    for a, b in zip(_column_patterns(_port(Cu), parent, cnt),
                    jax_colpat(Cu, parent, cnt)):
        assert np.array_equal(a, b)


_JAX = {}


def _jax_factored(name, A, kw):
    """The JAX package's plan and factored pools for one case, made once
    per module (every test rebuilds the same matrix from seed 0)."""
    if name not in _JAX:
        F = jss.SuperscanCholesky(A, **kw)
        assert F.factor()
        _JAX[name] = F
    return _JAX[name]


def _real_rows_err(plan, pools_t, pools_j):
    err, top = 0.0, 0.0
    for pw, r in plan.pool_rows.items():
        a = pools_t[pw][:r].astype(np.float64)
        b = np.asarray(pools_j[pw])[:r].astype(np.float64)
        if r:
            err = max(err, np.abs(a - b).max())
            top = max(top, np.abs(b).max())
    return err, top


@pytest.mark.parametrize("name", FACTOR_CASES)
def test_factor_parity(rng, monkeypatch, name):
    """Port factor vs JAX factor from the same initial pools.  f32 with
    another summation order, plus cancellation inside the diagonal
    factorizations: 1e-4 of max|L| over the real rows."""
    d, A, kw = _setup(name, rng, monkeypatch)
    J = _jax_factored(name, A, kw)
    T = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    assert T.factor()
    err, top = _real_rows_err(T.plan, tss.pools_to_numpy(T.pools), J.pools)
    assert err <= 1e-4 * top


@pytest.mark.parametrize("name", FACTOR_CASES)
def test_solve_parity_on_jax_factor(rng, monkeypatch, name):
    """The port's solve on the JAX factor (load_pools): f32 solve within
    1e-5 of JAX's, refined solve equal to the host engine's and at the
    reference residual grade."""
    from tpusparse.numeric import cholsol as host_cholsol
    d, A, kw = _setup(name, rng, monkeypatch)
    J = _jax_factored(name, A, kw)
    T = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    T.load_pools({pw: np.asarray(v) for pw, v in J.pools.items()})
    b = rng.normal(size=A.n)
    xt, xj = T._solve_f32(b), J._solve_f32(b)
    assert np.abs(xt - xj).max() <= 1e-5 * np.abs(xj).max()
    x = T.solve(b)
    ok, xh = host_cholsol(1, A, b.copy())
    assert ok
    assert np.allclose(xh, x, atol=1e-9)
    assert resid(d, x, b) < 1e-12


def test_factor_from_jax_initial_pools(rng):
    """load_pools takes plan.pool_init of the JAX plan; factoring the
    loaded pools with the port's _factor gives the port's factor."""
    d, A = _spd(rng, 90, 0.15)
    T = tss.SuperscanCholesky(_port(A), device="cpu",
                              **CASES["spd90_o1"][1])
    qplan = jss.plan_superscan(A, **CASES["spd90_o1"][1])
    T.load_pools(qplan.pool_init)
    pools = tss._factor(T.plan, T.pools)
    assert T.factor()
    for pw in pools:
        assert torch.allclose(pools[pw], T.pools[pw], rtol=0, atol=1e-6)


def test_factor_without_a_schedule_uploads_its_own(rng):
    """``_factor`` given no schedule packs and uploads one for the call
    (``sched_uploads`` 1 on the caller's span) and factors as
    ``factor()`` does, bit for bit, beside an object whose schedule is
    resident."""
    d, A = _spd(rng, 90, 0.15)
    T = tss.SuperscanCholesky(_port(A), device="cpu",
                              **CASES["spd90_o1"][1])
    assert T.factor() and T.factor()
    with recording() as rec:
        with span("superscan.factor"):
            pools = tss._factor(T.plan, tss.pools_from_numpy(
                T.plan.pool_init, "cpu"))
    root, = [s for s in rec if s.parent == -1]
    assert root.counts == {"sched_uploads": 1}
    assert [s.name for s in rec].count("superscan.factor.upload") == 1
    assert pools.keys() == T.pools.keys()
    for pw in pools:
        assert torch.equal(pools[pw], T.pools[pw])


RESIDENT_CASES = ["spd90_o1", "band", "agg_mixed"]


def _factored_thrice(name, rng, monkeypatch):
    """(an object factored three times, a fresh one factored once) of
    CASES[name], the uploads of each of the three factors recorded:
    [(sched_uploads, [h2d_bytes of each upload span])]."""
    d, A, kw = _setup(name, rng, monkeypatch)
    F = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    ups = []
    for _ in range(3):
        with recording() as rec:
            assert F.factor()
        root, = [s for s in rec if s.parent == -1]
        ups.append((root.counts["sched_uploads"],
                    [s.counts["h2d_bytes"] for s in rec
                     if s.name == "superscan.factor.upload"]))
    G = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    assert G.factor()
    return F, G, ups


@pytest.mark.parametrize("name", RESIDENT_CASES)
def test_refactor_is_bit_for_bit(rng, monkeypatch, name):
    """Three factors of one object leave the pools of a fresh object's
    one factor, bit for bit: the resident schedule and the held initial
    pools serve every factor as the first."""
    F, G, _ = _factored_thrice(name, rng, monkeypatch)
    assert F.pools.keys() == G.pools.keys()
    for pw in G.pools:
        assert torch.equal(F.pools[pw], G.pools[pw]), pw


@pytest.mark.parametrize("name", RESIDENT_CASES)
def test_sched_uploads_counts_the_first_factor_only(rng, monkeypatch,
                                                     name):
    """``sched_uploads`` on the factor's span reads 1 on the plan's first
    factor and 0 after; the first factor's upload spans count the pools
    and the schedule, each later one the pools' f32 bytes alone."""
    F, _, ups = _factored_thrice(name, rng, monkeypatch)
    pools = sum(v.size * 4 for v in F.plan.pool_init.values())
    sched = sum(a.size * 4 for s in F.plan.segments if s.xs
                for d in s.xs.values() for a in d.values())
    assert ups == [(1, [pools, sched]), (0, [pools]), (0, [pools])]


@pytest.mark.parametrize("name", RESIDENT_CASES)
def test_no_phase_writes_into_the_resident_schedule(rng, monkeypatch,
                                                    name):
    """The schedule the first factor left on the device is, after two
    more factors, the plan's arrays in int64, entry for entry; its host
    buffer is gone."""
    F, _, _ = _factored_thrice(name, rng, monkeypatch)
    packed = F._factor_sched
    assert packed.host is None
    segs = [s for s in F.plan.segments if s.xs]
    assert len(packed.scheds) == len(segs)
    for seg, xs in zip(segs, packed.scheds):
        assert xs.keys() == seg.xs.keys()
        for k, d in seg.xs.items():
            for nm, a in d.items():
                v = xs[k][nm]
                assert v.dtype == torch.int64 and v.shape == a.shape
                assert np.array_equal(v.numpy(), a), (k, nm)


def test_factored_pools_never_share_the_initial_pools(rng):
    """Writing into the returned pools changes neither ``plan.pool_init``
    nor the next factor, which still gives the first one's pools."""
    d, A = _spd(rng, 90, 0.15)
    F = tss.SuperscanCholesky(_port(A), device="cpu",
                              **CASES["spd90_o1"][1])
    init = {pw: v.copy() for pw, v in F.plan.pool_init.items()}
    assert F.factor()
    first = {pw: v.clone() for pw, v in F.pools.items()}
    for v in F.pools.values():
        v.fill_(float("nan"))
    for pw, v in F.plan.pool_init.items():
        assert np.array_equal(v, init[pw])
    assert F.factor()
    for pw in first:
        assert torch.equal(F.pools[pw], first[pw])


def test_not_positive_definite():
    d = np.eye(8)
    d[4, 4] = -1.0
    A = csc_from_dense(d + 0.01 * np.ones((8, 8)))
    F = tss.SuperscanCholesky(_port(A), order=0, wmax=8, device="cpu")
    assert F.factor() is False
    with pytest.raises(ValueError):
        F.solve(np.ones(8))


def test_switch_ladders_match_mask_mode(rng, monkeypatch):
    """Runtime-sized phases (ladder rungs) agree with full-capacity mask
    mode: idle slots add exact zeros.  Not bit for bit: the CPU GEMM may
    block differently at another batch size."""
    d, A = _spd(rng, 150, 0.08)
    b = rng.normal(size=A.n)
    monkeypatch.setenv("TPUSPARSE_SWITCH", "0")
    F0 = tss.SuperscanCholesky(_port(A), order=1, wmax=16, small_w=4,
                               device="cpu")
    assert not any(s.ladders for s in F0.plan.segments)
    assert F0.factor()
    x0 = F0._solve_f32(b)
    monkeypatch.setenv("TPUSPARSE_SWITCH", "1")
    monkeypatch.setenv("TPUSPARSE_SWITCH_MIN_FLOPS", "0")
    F1 = tss.SuperscanCholesky(_port(A), order=1, wmax=16, small_w=4,
                               device="cpu")
    assert any(s.ladders for s in F1.plan.segments)
    assert F1.factor()
    x1 = F1._solve_f32(b)
    assert np.allclose(x0, x1, rtol=1e-6, atol=0)


def test_aggregated_update_path(rng, monkeypatch):
    """Twin of test_superscan.py::test_aggregated_update_path: with
    TPUSPARSE_AGG=1 the plan has the updg/upda phases and a scratch, and
    the port factors it; solve and solve_host reach the reference
    grade."""
    monkeypatch.setenv("TPUSPARSE_AGG", "1")
    for n, dens in ((40, 0.3), (90, 0.12)):
        d, A = _spd(rng, n, dens)
        F = tss.SuperscanCholesky(_port(A), order=1, device="cpu", **SMALL)
        kinds = {k[0] for s in F.plan.segments for k in s.xs}
        assert "updg" in kinds and "upda" in kinds
        assert any(s.scratch_rows > 0 for s in F.plan.segments)
        assert F.factor()
        b = rng.normal(size=n)
        assert resid(d, F.solve(b), b) < 1e-12
        assert resid(d, F.solve_host(b), b) < 1e-12


def test_aggregated_mixed_case_has_every_kind(rng, monkeypatch):
    """The agg_mixed case's plan has all six phase kinds, and steps that
    run per-pair and aggregated updates together."""
    d, A, kw = _setup("agg_mixed", rng, monkeypatch)
    p = tsp.plan_superscan(_port(A), **kw)
    assert {k[0] for s in p.segments for k in s.xs} == {
        "upd", "upds", "updg", "upda", "chol", "trsm"}
    mixed = 0
    for s in p.segments:
        for step in range(s.hi - s.lo):
            kinds = {k[0] for k, v in s.xs.items()
                     if k[0] in ("upd", "upds", "updg")
                     and (v["src"][step] >= 0).any()}
            mixed += "updg" in kinds and len(kinds) > 1
    assert mixed > 0


@pytest.mark.parametrize("name", ["agg40", "agg90", "agg_mixed"])
def test_aggregated_scratch_starts_poisoned(rng, monkeypatch, name):
    """The factor from a scratch full of NaN is finite and bit for bit
    the factor from a zeroed one: no upda reads a row or a lane of the
    scratch that its step's updg did not write (JAX zeroes the scratch
    per segment and pads each delta to 128 lanes; the port does
    neither).  The trimmed batches (``_fills``) also give the full
    capacity's factor."""
    d, A, kw = _setup(name, rng, monkeypatch)
    F = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    assert F.factor()
    monkeypatch.setattr(tss, "_scratch", lambda rows, device: torch.full(
        (rows, tss.SCRATCH_LANES), float("nan"), device=device))
    G = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    assert G.factor()
    for pw in F.pools:
        assert torch.equal(G.pools[pw], F.pools[pw]), pw
    monkeypatch.setattr(tss, "_fills", lambda xs: {})
    H = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    assert H.factor()
    err, top = _real_rows_err(F.plan, tss.pools_to_numpy(H.pools),
                              tss.pools_to_numpy(F.pools))
    assert err <= 1e-6 * top


def test_aggregated_fills_count_the_active_units(monkeypatch):
    """``_fills`` on the canonical AGG plan: each step's count covers
    every active unit and no slot past it is active; steps with no
    active unit launch nothing."""
    monkeypatch.setenv("TPUSPARSE_AGG", "1")
    p = tsp.plan_superscan(_port(_grid3d(12)), order=1)
    seen = 0
    for seg in p.segments:
        for key, fill in tss._fills(seg.xs).items():
            arr = seg.xs[key]["src" if key[0] == "updg" else "srd"]
            act = (arr >= 0).any(axis=2)
            for step, f in enumerate(fill):
                assert not act[step, f:].any()
                assert f == 0 or act[step, f - 1]
            seen += 1
    assert seen > 0


def test_cholsol_entry_point(rng, monkeypatch):
    """cholsol routes as tpusparse/device/solvers.py:53-57 does: "auto"
    is supernodal below n = 16,384 (superscan from there up); every
    engine solves; an unknown engine raises."""
    from tpusparse_torch.device import solvers
    d, A = _spd(rng, 60, 0.2)
    b = rng.normal(size=60)
    A = _port(A)
    made = []

    def spy(cls):
        class Spy(cls):
            def __init__(self, *a, **kw):
                made.append(cls.__name__)
                super().__init__(*a, **kw)
        return Spy

    for name in ("SuperscanCholesky", "SupernodalCholesky", "TpuCholesky"):
        monkeypatch.setattr(solvers, name, spy(getattr(solvers, name)))
    ok, x = tpusparse_torch.cholsol(1, A, b, device="cpu")
    assert ok and made == ["SupernodalCholesky"]
    assert resid(d, x, b) < 1e-12
    assert tpusparse_torch.cholsol(1, A, b[:-1], device="cpu") == (False,
                                                                   None)
    for engine, cls in (("superscan", "SuperscanCholesky"),
                        ("supernodal", "SupernodalCholesky"),
                        ("tiled", "TpuCholesky")):
        made.clear()
        ok, x = tpusparse_torch.cholsol(1, A, b, engine=engine,
                                        device="cpu")
        assert ok and made == [cls]
        assert resid(d, x, b) < 1e-12
    monkeypatch.setattr(solvers, "SUPERSCAN_MIN_N", 60)
    made.clear()
    assert tpusparse_torch.cholsol(1, A, b, device="cpu")[0]
    assert made == ["SuperscanCholesky"]
    with pytest.raises(ValueError):
        tpusparse_torch.cholsol(1, A, b, engine="dense", device="cpu")


def test_cholsol_not_positive_definite():
    d = np.eye(8)
    d[4, 4] = -1.0
    A = csc_from_dense(d + 0.01 * np.ones((8, 8)))
    assert tpusparse_torch.cholsol(0, _port(A), np.ones(8),
                                   device="cpu") == (
        False, None)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        tss.SuperscanCholesky(_port(csc_from_dense(np.eye(8))))


def test_pools_round_trip(rng):
    pools = {32: rng.normal(size=(40, 32)).astype(np.float32),
             128: np.zeros((0, 128), np.float32)}
    t = tss.pools_from_numpy(pools, "cpu")
    t[32][0, 0] = 7.0                 # never shares memory with the input
    assert pools[32][0, 0] != 7.0
    back = tss.pools_to_numpy(t)
    assert back[128].shape == (0, 128)
    assert np.array_equal(back[32][1:], pools[32][1:])


def test_solve_runs_without_the_relay_slot_cap(rng, monkeypatch):
    """The port's solve schedule has no slot cap: under a
    TPUSPARSE_SOLVE_SLOT_CAP that splits every JAX solve step into
    sub-steps, the port's solve still walks exactly the factor's
    (padded) steps, and solves to the reference grade."""
    monkeypatch.setenv("TPUSPARSE_SOLVE_SLOT_CAP", "1")
    d, A = _spd(rng, 200, 0.1)
    b = rng.normal(size=A.n)
    kw = dict(order=1, wmax=16, small_w=4)
    F = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    factor_steps = _steps(s.xs for s in F.plan.segments)
    assert _steps(tsp._solve_xs(F.plan)) == factor_steps
    assert _steps(jss._solve_xs(jss.plan_superscan(A, **kw))) > factor_steps
    assert F.factor()
    assert resid(d, F.solve(b), b) < 1e-12


# ---------------------------------------------------- the packed solve sweep
_BMM = torch.bmm


def _slotwise_bmm(a, b):
    """``torch.bmm`` one slot at a time.  Torch's CPU ``bmm`` computes a
    batch of one through ``mm`` (a matrix-vector product at one column)
    and a larger batch another way once a slot passes 400 multiply-adds,
    so a slot's last bit can depend on its batch's size (as a rank's
    slice of one unit does in the sharded solve); here it cannot."""
    if not len(a):
        return _BMM(a, b)
    return torch.stack([torch.mm(x, y) for x, y in zip(a, b)])


def _full_capacity_sweep(F, B, eng):
    """x of one f32 sweep over every key of ``_solve_xs`` at every step at
    full capacity, padded slots included, row n zeroed after each step
    (the sweep as it ran before its pairs were packed), with the
    ``_diag_solve`` and ``_od_delta`` of the engine's module ``eng``; an
    LU's row matching is applied to B first, as its ``_solve_f32_many``
    applies it."""
    plan, c = F.plan, tss._Consts("cpu")
    n = plan.n
    if getattr(F, "_match_p", None) is not None:
        B = B[F._match_p]
    x0 = np.zeros((n + 1, B.shape[1]), np.float32)
    x0[:n] = B[plan.perm]
    xpad = torch.from_numpy(x0)

    def sweep(xs, backward):
        keys = sorted(xs)
        ck = [k for k in keys if k[0] == "chol"]
        tk = [k for k in keys if k[0] == "trsm"]
        steps = next(iter(xs[keys[0]].values())).shape[0]
        for step in (range(steps - 1, -1, -1) if backward
                     else range(steps)):
            at = {k: {nm: v[step] for nm, v in xs[k].items()} for k in keys}
            if not backward:
                for k in ck:
                    eng._diag_solve(F.pools, k, at[k], xpad, c, False)
            tss._od_solve(F.pools, [(k, at[k]) for k in tk], xpad, c,
                          backward, delta=eng._od_delta)
            if backward:
                for k in ck:
                    eng._diag_solve(F.pools, k, at[k], xpad, c, True)
            xpad[n] = 0.0

    full = tss._Packed([xs for xs in tsp._solve_xs(plan) if xs]).upload(
        "cpu")
    for xs in full:
        sweep(xs, False)
    for xs in reversed(full):
        sweep(xs, True)
    X = np.zeros((n, B.shape[1]))
    X[plan.perm] = xpad[:n].numpy()
    return X


# the LU cases of test_torch_superscan_lu.py that the shared solve sweep
# is also held on, named "lu_<case>"
LU_SWEEP_CASES = ["lu_fuzz60", "lu_matched"]


def _engine(name, rng, monkeypatch):
    """(engine, its module) for a case of ``FACTOR_CASES`` or
    ``LU_SWEEP_CASES``, not yet factored."""
    if name.startswith("lu_"):
        from test_torch_superscan_lu import CASES as LU_CASES
        from tpusparse_torch.device import superscan_lu as tlu
        make, kw = LU_CASES[name[3:]]
        return tlu.SuperscanLU(_port(make(rng)), device="cpu", **kw), tlu
    d, A, kw = _setup(name, rng, monkeypatch)
    return tss.SuperscanCholesky(_port(A), device="cpu", **kw), tss


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", FACTOR_CASES + LU_SWEEP_CASES)
def test_packed_sweep_is_bit_for_bit_the_full_capacity_one(
        rng, monkeypatch, name, k):
    """The f32 sweep over the packed pairs (``_solve_f32_many``) returns
    exactly the x of the full-capacity loop on k right-hand sides, for
    the Cholesky and the LU alike: a padded slot only writes row n or
    adds zeros to it.  Both run with ``_slotwise_bmm``, so that a batch
    cut to its fill computes each of its slots as the full batch does."""
    F, eng = _engine(name, rng, monkeypatch)
    assert F.factor()
    B = rng.normal(size=(F.A.n, k))
    monkeypatch.setattr(torch, "bmm", _slotwise_bmm)
    assert np.array_equal(F._solve_f32_many(B),
                          _full_capacity_sweep(F, B, eng))


def _packed_by_slot(xs_list, n):
    """The packed solve schedule of ``_solve_xs``'s segments, each slot's
    reality judged in Python: per step, {key: {name: rows up to the last
    real slot}} of the pairs that have one."""
    out = []
    for xs in xs_list:
        keys = sorted(xs)
        for step in range(_steps([xs])):
            got = {}
            for k in keys:
                d = xs[k]
                fill = 0
                for u in range(d["cols"].shape[1]):
                    real = any(int(v) < n for v in d["cols"][step, u])
                    if k[0] == "trsm":
                        real |= any(int(v) < n for v in d["tgt"][step, u])
                    if real:
                        fill = u + 1
                if fill:
                    got[k] = {nm: v[step, :fill] for nm, v in d.items()}
            if got:
                out.append(got)
    return out


@pytest.mark.parametrize("name", ["spd90_o1", "band", "seg_dp",
                                  "agg_mixed"] + LU_SWEEP_CASES)
def test_packed_solve_schedule_keeps_the_real_pairs(rng, monkeypatch, name):
    """The solve schedule on the device holds exactly the pairs with a
    real slot, each cut to its last real slot, keys in sorted order, in
    int64 in one buffer of just their entries; the full-capacity
    schedule holds more.  The LU's schedule is built the same way."""
    F = _engine(name, rng, monkeypatch)[0]
    full = [xs for xs in tsp._solve_xs(F.plan) if xs]
    want = _packed_by_slot(full, F.plan.n)
    got = F._sched()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w) == sorted(w)
        for k in w:
            assert g[k].keys() == w[k].keys()
            for nm, a in w[k].items():
                assert g[k][nm].dtype == torch.int64
                assert np.array_equal(g[k][nm].numpy(), a), (k, nm)
    entries = sum(a.size for w in want for dd in w.values()
                  for a in dd.values())
    buf = next(iter(next(iter(got[0].values())).values()))
    assert buf.untyped_storage().nbytes() == 8 * entries
    assert entries < sum(a.size for xs in full for dd in xs.values()
                         for a in dd.values())


def test_packed_solve_schedule_is_smaller_on_the_canonical_grid():
    """At g=24 the packed solve schedule keeps under half the pairs and
    under a quarter of the full-capacity schedule's entries (595 of
    1,528 pairs, 400,855 of 2,085,716 entries)."""
    p = tsp.plan_superscan(_port(_grid3d(24)), order=1)
    full = [xs for xs in tsp._solve_xs(p) if xs]
    steps = [st for xs in full for st in tss._solve_steps(xs, p.n)]
    pairs = sum(map(len, steps))
    entries = sum(a.size for st in steps for dd in st.values()
                  for a in dd.values())
    assert 0 < pairs < 0.5 * sum(len(xs) * _steps([xs]) for xs in full)
    assert 0 < entries < 0.25 * sum(a.size for xs in full
                                   for dd in xs.values()
                                   for a in dd.values())


def test_fill_reaches_the_last_real_slot():
    """A hand-made schedule whose real slots do not form a prefix: a
    pair's fill reaches its last real slot, padded slots before it kept;
    a trsm slot real by ``tgt`` alone counts; pairs and steps with no
    real slot go."""
    n = 10
    cc = np.full((4, 4, 2), n, np.int32)
    cc[0, 0], cc[0, 2] = [0, 1], [2, n]    # slot 1 padded between
    cc[2, 3] = [4, 5]                      # only the last slot real
    tc = np.full((4, 3, 2), n, np.int32)
    tt = np.full((4, 3, 2), n, np.int32)
    tt[1, 1] = [n, 7]                      # real by its target alone
    xs = {("chol", 8, 2): {"dbase": np.arange(16, dtype=np.int32)
                           .reshape(4, 4), "cols": cc},
          ("trsm", 8, 2, 2): {"rows": np.arange(24, dtype=np.int32)
                              .reshape(4, 3, 2), "cols": tc, "tgt": tt}}
    got = tss._solve_steps(xs, n)
    assert [{k: next(iter(d.values())).shape[0] for k, d in st.items()}
            for st in got] == [{("chol", 8, 2): 3}, {("trsm", 8, 2, 2): 2},
                               {("chol", 8, 2): 4}]
    assert np.array_equal(got[0][("chol", 8, 2)]["cols"], cc[0, :3])
    assert np.array_equal(got[1][("trsm", 8, 2, 2)]["rows"],
                          xs[("trsm", 8, 2, 2)]["rows"][1, :2])
    assert np.array_equal(got[2][("chol", 8, 2)]["dbase"], [8, 9, 10, 11])


# ------------------------------------------ solve_many, solve_host, updown
def test_metrics(rng):
    """Twin of test_superscan.py::test_metrics, equal to JAX's metrics
    on the same matrix."""
    d, A = _spd(rng, 50, 0.3)
    F = tss.SuperscanCholesky(_port(A), order=1, wmax=16, device="cpu")
    m = F.metrics().values
    assert m["chol_engine"] == "superscan"
    assert m["chol_panels"] > 0 and m["chol_segments"] >= 1
    assert m == jss.SuperscanCholesky(A, order=1, wmax=16).metrics().values


def test_solve_many(rng):
    """Twin of test_superscan.py::test_solve_many; each column also
    against JAX's solve_many on its own factor (both refined: 1e-9 of
    max|X|), and the port's f32 multi-RHS pass on the JAX factor against
    JAX's within 1e-5, column by column against the one-RHS pass."""
    d, A = _spd(rng, 50, 0.25)
    kw = dict(order=1, wmax=16, tau=0.9, small_w=4)
    F = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    assert F.factor()
    B = rng.normal(size=(50, 3))
    X = F.solve_many(B)
    for j in range(3):
        assert resid(d, X[:, j], B[:, j]) < 1e-12
    J = jss.SuperscanCholesky(A, **kw)
    assert J.factor()
    XJ = J.solve_many(B)
    assert np.abs(X - XJ).max() <= 1e-9 * np.abs(XJ).max()
    T = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    T.load_pools({pw: np.asarray(v) for pw, v in J.pools.items()})
    X32 = T._solve_f32_many(B)
    for j in range(3):
        xj = J._solve_f32(B[:, j])
        assert np.abs(X32[:, j] - xj).max() <= 1e-5 * np.abs(xj).max()
        assert np.allclose(X32[:, j], T._solve_f32(B[:, j]), rtol=0,
                           atol=1e-6 * np.abs(xj).max())
    assert np.array_equal(F.solve_many(B[:, 0]), F.solve(B[:, 0]))


def test_solve_host_matches_solve(rng):
    """solve_host (host f64 trisolves on the downloaded factor) against
    the device solve: both refined to the reference grade, within 1e-10
    of each other; the host copy of L is made once."""
    d, A = _spd(rng, 90, 0.15)
    F = tss.SuperscanCholesky(_port(A), device="cpu", **CASES["spd90_o1"][1])
    b = rng.normal(size=A.n)
    xh = F.solve_host(b)                  # factors on first use
    L = F._Lhost
    x = F.solve(b)
    assert resid(d, xh, b) < 1e-12 and resid(d, x, b) < 1e-12
    assert np.abs(xh - x).max() <= 1e-10 * np.abs(x).max()
    F.solve_host(b)
    assert F._Lhost is L
    assert F.factor() and F._Lhost is None


def _w_on_column_of_L(F, k, rng):
    """w on every stored row of the column of L that belongs to original
    column k, in original coordinates (test_superscan.py's recipe)."""
    perm = F.plan.perm
    kp = int(np.flatnonzero(perm == k)[0])
    w = w_on_column(F.extract_L(), perm, kp, rng, nonzero=False)
    return w, np.flatnonzero(w)


def test_updown_device_resident(rng):
    """Twin of test_superscan.py::test_updown_device_resident: the
    superscan rank-1 update and downdate on the flat pools, the pools
    views into one flat tensor afterwards; a failed downdate keeps the
    old pools, bit for bit."""
    d, A = _spd(rng, 36, 0.35)
    F = tss.SuperscanCholesky(_port(A), order=1, wmax=16, tau=0.9,
                              small_w=4, device="cpu")
    assert F.factor()
    w, widx = _w_on_column_of_L(F, 18, rng)
    assert F.updown(+1, w)
    assert all(isinstance(v, torch.Tensor) and v.device == F.device
               for v in F.pools.values())
    assert len({v.untyped_storage().data_ptr()
                for v in F.pools.values()}) == 1
    dn = d + np.outer(w, w)
    b = rng.normal(size=36)
    x = F.solve_host(b)
    assert resid(dn, x, b) < 1e-12
    assert resid(dn, F.solve(b), b) < 1e-12
    assert np.allclose(F.A.todense(), dn, rtol=0, atol=1e-12)
    # downdate back
    assert F.updown(-1, w)
    x = F.solve_host(b)
    assert resid(d, x, b) < 1e-12
    # failed downdate keeps the old pools and returns False
    w2 = np.zeros(36)
    w2[widx] = 40.0 * np.abs(d).max()
    old = F.pools
    kept = {pw: v.clone() for pw, v in old.items()}
    assert F.updown(-1, w2) is False
    assert F.pools is old
    assert all(torch.equal(kept[pw], old[pw]) for pw in old)
    assert resid(d, F.solve(b), b) < 1e-12


@pytest.mark.parametrize("name", ["spd90_o1", "band"])
def test_updown_matches_jax(rng, monkeypatch, name):
    """The port's updown on the JAX factor (load_pools) against JAX's
    updown of the same factor: the updated pools within the pool
    tolerance of test_factor_parity, update and downdate, and the
    schedule equal to JAX's."""
    d, A, kw = _setup(name, rng, monkeypatch)
    J = jss.SuperscanCholesky(A, **kw)
    assert J.factor()
    T = tss.SuperscanCholesky(_port(A), device="cpu", **kw)
    T.load_pools({pw: np.asarray(v) for pw, v in J.pools.items()})
    w, _ = _w_on_column_of_L(T, A.n // 2, rng)
    js, ts = J._updown_sched(), T._updown_sched()
    assert (ts["H"], ts["total"], ts["pws"]) == (js["H"], js["total"],
                                                 js["pws"])
    for nm in ("dflat", "colidx", "rowid"):
        assert np.array_equal(np.asarray(ts[nm]), np.asarray(js[nm]))
    for sigma in (+1, -1):
        assert J.updown(sigma, w) and T.updown(sigma, w)
        err, top = _real_rows_err(T.plan, tss.pools_to_numpy(T.pools),
                                  J.pools)
        assert err <= 1e-4 * top


def test_updown_needs_w_on_the_numerical_pattern():
    """demo3's recipe on the superscan factor takes the rows where column
    n/2 of L is nonzero: the panels also store the zeros that
    amalgamation adds, and a w on all the stored rows fills outside the
    stored structure.  Then both packages give the same wrong factor
    (not a port fault); on the nonzero rows the update is exact."""
    A = _grid3d(10)
    n = A.n
    d = A.toscipy().toarray()
    b = np.ones(n)
    for numerical in (False, True):
        T = tss.SuperscanCholesky(_port(A), order=1, device="cpu")
        J = jss.SuperscanCholesky(A, order=1)
        assert T.factor() and J.factor()
        w = w_on_column(T.extract_L(), T.plan.perm, n // 2,
                        np.random.default_rng(24), nonzero=numerical)
        assert T.updown(+1, w) and J.updown(+1, w)
        dn = d + np.outer(w, w)
        rt, rj = resid(dn, T.solve(b), b), resid(dn, J.solve(b), b)
        if numerical:
            assert rt < 1e-12 and rj < 1e-12
        else:
            assert rt > 1e-6 and abs(rt - rj) <= 1e-3 * rj
