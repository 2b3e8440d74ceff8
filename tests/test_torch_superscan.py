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
from tpusparse_torch.device.patterns import _column_patterns
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
}
# the factor/solve parity cases (each costs a JAX compile of its own)
FACTOR_CASES = ["spd25_o0", "spd90_o1", "spd180_o1", "band", "seg_dp",
                "switch1"]


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


def test_aggregated_phases_not_ported(rng, monkeypatch):
    monkeypatch.setenv("TPUSPARSE_AGG", "1")
    d, A = _spd(rng, 40, 0.3)
    F = tss.SuperscanCholesky(_port(A), order=1, device="cpu", **SMALL)
    assert {"updg", "upda"} <= {k[0] for s in F.plan.segments for k in s.xs}
    with pytest.raises(NotImplementedError):
        F.factor()


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
