"""tpusparse_torch supernodal Cholesky (SupernodalCholesky) against the
JAX package, on the CPU: the copied planner bit for bit, the factor from
the same initial pools, the solve on the same factor, and a twin of
every tests/test_supernodal.py test.  Inputs are made with numpy seeds
and handed to both packages."""

import numpy as np
import pytest
import torch

from tpusparse.core import csc_from_dense
from tpusparse.device import supernodal as jsn
import tpusparse_torch
from tpusparse_torch.core import CSCMatrix as TCSC
from tpusparse_torch.device import supernodal as tsn
from tpusparse_torch.device.chol_plan import plan_cholesky
from tpusparse_torch.device.chol_tpu import TpuCholesky
from tpusparse_torch.device.supernodal import (SupernodalCholesky,
                                               plan_supernodal)
from helpers import random_spd, resid
from test_torch_chol_tpu import _grid3d


def _port(A):
    """The port's CSCMatrix from the arrays of the JAX package's."""
    return TCSC(A.m, A.n, A.indptr, A.indices, A.data)


def _not_spd():
    d = np.eye(10)
    d[6, 6] = -3.0
    return csc_from_dense(d), None


# name -> (matrix maker, planner kwargs): the matrices of
# tests/test_supernodal.py under the settings its tests use, and two
# narrow-panel settings
CASES = {
    "spd30": (lambda r: random_spd(r, 30, 0.3), dict(order=1)),
    "spd120": (lambda r: random_spd(r, 120, 0.1), dict(order=1)),
    "spd250": (lambda r: random_spd(r, 250, 0.05), dict(order=1)),
    "spd60_o0": (lambda r: random_spd(r, 60, 0.15), dict(order=0)),
    "spd100": (lambda r: random_spd(r, 100, 0.1), dict(order=1)),
    "spd200": (lambda r: random_spd(r, 200, 0.05), dict(order=1)),
    "spd80": (lambda r: random_spd(r, 80, 0.1), dict(order=1)),
    "grid8": (lambda r: _grid3d(8), dict(order=1)),
    "not_spd": (lambda r: _not_spd(), dict(order=0)),
    "spd150_narrow": (lambda r: random_spd(r, 150, 0.05),
                      dict(order=1, wmax=16, tau=0.5, small_w=4)),
    "grid6_narrow": (lambda r: _grid3d(6),
                     dict(order=1, wmax=32, tau=0.9, small_w=8)),
}
# the factor/solve parity cases (each costs JAX compiles of its own)
FACTOR_CASES = ["spd120", "spd150_narrow", "grid6_narrow"]


def _assert_plans_equal(p, q):
    for f in ("n", "nlevels", "flops_true", "flops_padded", "lnz"):
        assert getattr(p, f) == getattr(q, f), f
    assert np.array_equal(p.perm, q.perm)
    assert np.array_equal(p.col2sn, q.col2sn)
    assert len(p.snodes) == len(q.snodes)
    for a, b in zip(p.snodes, q.snodes):
        assert (a.sid, a.c0, a.w, a.level, a.bucket, a.slot) == \
            (b.sid, b.c0, b.w, b.level, b.bucket, b.slot)
        assert a.rows.dtype == b.rows.dtype
        assert np.array_equal(a.rows, b.rows)
    assert p.buckets == q.buckets
    assert list(p.pool_init) == list(q.pool_init)
    for b in p.pool_init:
        assert p.pool_init[b].dtype == q.pool_init[b].dtype
        assert np.array_equal(p.pool_init[b], q.pool_init[b])
    assert len(p.level_factor) == len(q.level_factor) == p.nlevels
    for s, t in zip(p.level_factor, q.level_factor):
        assert list(s) == list(t)
        for b in s:
            assert s[b].dtype == t[b].dtype
            assert np.array_equal(s[b], t[b])
    assert len(p.level_updates) == len(q.level_updates)
    for s, t in zip(p.level_updates, q.level_updates):
        assert list(s) == list(t)
        for k in s:
            assert len(s[k]) == len(t[k]) == 4
            for x, y in zip(s[k], t[k]):
                assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_parity(rng, name):
    build, kw = CASES[name]
    A, _ = build(rng)
    _assert_plans_equal(plan_supernodal(_port(A), **kw),
                        jsn.plan_supernodal(A, **kw))


def test_solve_schedule_matches_jax_loop(rng):
    """The port's solve schedule against the JAX ``_solve_fn`` loop that
    builds ``fwd_sched`` (supernodal.py:385-400), redone here on the JAX
    plan."""
    A, _ = random_spd(rng, 150, 0.05)
    kw = CASES["spd150_narrow"][1]
    plan = jsn.plan_supernodal(A, **kw)
    got = tsn._solve_xs(plan_supernodal(_port(A), **kw))
    for lvl in range(plan.nlevels):
        assert list(got[lvl]) == list(plan.level_factor[lvl])
        for b, slots in plan.level_factor[lvl].items():
            R, W = b
            sns = sorted([s for s in plan.snodes if s.bucket == b
                          and s.slot in set(slots.tolist())
                          and s.level == lvl], key=lambda s: s.slot)
            g = got[lvl][b]
            assert np.array_equal(g["slots"], [s.slot for s in sns])
            assert np.array_equal(g["cols"], np.stack(
                [np.arange(s.c0, s.c0 + W) for s in sns]))
            for i, s in enumerate(sns):
                assert np.array_equal(g["odr"][i, :s.rows.size], s.rows)
                assert (g["odr"][i, s.rows.size:] == plan.n).all()


_JAX = {}


def _jax_factored(name, A, kw):
    """The JAX package's factor object for one case, made once per
    module (every test rebuilds the same matrix from seed 0)."""
    if name not in _JAX:
        F = jsn.SupernodalCholesky(A, **kw)
        assert F.factor()
        _JAX[name] = F
    return _JAX[name]


def _setup(name, rng):
    build, kw = CASES[name]
    A, S = build(rng)
    return S.toarray(), A, kw


@pytest.mark.parametrize("name", FACTOR_CASES)
def test_factor_parity(rng, name):
    """Port factor vs JAX ``_factor_fn`` from the same initial pools: f32
    with another summation order, 1e-4 of max|L|."""
    d, A, kw = _setup(name, rng)
    J = _jax_factored(name, A, kw)
    T = SupernodalCholesky(_port(A), device="cpu", **kw)
    assert T.factor()
    got = tsn.pools_to_numpy(T.pools)
    assert sorted(got) == sorted(J.pools)
    err = max(np.abs(got[b] - np.asarray(J.pools[b])).max() for b in got)
    top = max(np.abs(np.asarray(v)).max() for v in J.pools.values())
    assert err <= 1e-4 * top


def test_factor_from_jax_initial_pools(rng):
    """load_pools takes plan.pool_init of the JAX plan; the port's _factor
    on the loaded pools gives the port's factor."""
    d, A, kw = _setup("spd120", rng)
    T = SupernodalCholesky(_port(A), device="cpu", **kw)
    T.load_pools(jsn.plan_supernodal(A, **kw).pool_init)
    pools = tsn._factor(T.pools, T._factor_sched.upload(T.device),
                        T._consts)
    assert T.factor()
    for b in pools:
        assert torch.allclose(pools[b], T.pools[b], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", FACTOR_CASES)
def test_solve_parity_on_jax_factor(rng, name):
    """The port's solve on the JAX factor (load_pools): f32 solve within
    1e-5 of JAX's, refined solve equal to the host engine's and at the
    reference residual grade."""
    from tpusparse.numeric import cholsol as host_cholsol
    d, A, kw = _setup(name, rng)
    J = _jax_factored(name, A, kw)
    T = SupernodalCholesky(_port(A), device="cpu", **kw)
    T.load_pools({b: np.asarray(v) for b, v in J.pools.items()})
    b = rng.normal(size=A.n)
    xt, xj = T._solve_f32(b), J._solve_f32(b)
    assert np.abs(xt - xj).max() <= 1e-5 * np.abs(xj).max()
    x = T.solve(b)
    ok, xh = host_cholsol(1, A, b.copy())
    assert ok
    assert np.allclose(xh, x, atol=1e-9)
    assert resid(d, x, b) < 1e-12


def test_pools_round_trip(rng):
    pools = {(16, 8): rng.normal(size=(3, 16, 8)).astype(np.float32),
             (8, 8): np.zeros((0, 8, 8), np.float32)}
    t = tsn.pools_from_numpy(pools, "cpu")
    t[(16, 8)][0, 0, 0] = 7.0         # never shares memory with the input
    assert pools[(16, 8)][0, 0, 0] != 7.0
    back = tsn.pools_to_numpy(t)
    assert back[(8, 8)].shape == (0, 8, 8)
    assert np.array_equal(back[(16, 8)][1:], pools[(16, 8)][1:])


# ------------------------------------------- twins of test_supernodal.py
@pytest.mark.parametrize("n,dens", [(30, 0.3), (120, 0.1), (250, 0.05)])
def test_supernodal_solve(rng, n, dens):
    A, S = random_spd(rng, n, density=dens)
    F = SupernodalCholesky(_port(A), order=1, device="cpu")
    assert F.factor()
    b = 1.0 + np.arange(n) / n
    x = F.solve(b)
    assert resid(S.toarray(), x, b) < 1e-13


def test_supernodal_beats_fixed_tiles_on_amd(rng):
    A, S = random_spd(rng, 200, density=0.05)
    ps = plan_supernodal(_port(A), order=1)
    pt = plan_cholesky(_port(A), order=1, block=32)
    assert ps.flops_true == pt.flops_true            # same ordering class
    assert ps.flops_padded < pt.flops_padded         # fewer padded flops
    assert ps.waste_ratio <= pt.waste_ratio + 1e-9


def test_supernodal_not_spd():
    A, _ = _not_spd()
    F = SupernodalCholesky(_port(A), order=0, device="cpu")
    assert F.factor() is False
    with pytest.raises(ValueError):
        F.solve(np.ones(10))


def test_supernodal_natural_order(rng):
    A, S = random_spd(rng, 60, density=0.15)
    F = SupernodalCholesky(_port(A), order=0, device="cpu")
    assert F.factor()
    b = rng.normal(size=60)
    assert resid(S.toarray(), F.solve(b), b) < 1e-13


def test_supernodal_plan_stats(rng):
    A, S = random_spd(rng, 100, density=0.1)
    p = plan_supernodal(_port(A), order=1)
    assert p.lnz > 0
    assert 0 <= p.waste_ratio < 1
    assert sum(s.w for s in p.snodes) == 100
    assert np.array_equal(np.sort(np.unique(p.col2sn)),
                          np.arange(len(p.snodes)))


def test_supernodal_3d_grid_vs_tiled(rng):
    # the bench configuration in miniature: both port engines must agree
    A, S = _grid3d(8)                      # n=512
    b = 1.0 + np.arange(A.n) / A.n
    Fs = SupernodalCholesky(_port(A), order=1, device="cpu")
    assert Fs.factor()
    xs = Fs.solve(b)
    Ft = TpuCholesky(_port(A), order=0, block=64, device="cpu")
    assert Ft.factor()
    xt = Ft.solve(b)
    assert resid(S.toarray(), xs, b) < 1e-13
    assert resid(S.toarray(), xt, b) < 1e-13
    assert np.allclose(xs, xt, atol=1e-10)


def test_supernodal_solve_many(rng):
    n = 80
    A, S = random_spd(rng, n, density=0.1)
    F = SupernodalCholesky(_port(A), order=1, device="cpu")
    assert F.factor()
    B = rng.normal(size=(n, 4))
    X = F.solve_many(B)
    for j in range(4):
        assert resid(S.toarray(), X[:, j], B[:, j]) < 1e-13
    X32 = F._solve_f32_many(B)
    for j in range(4):
        assert np.allclose(X32[:, j], F._solve_f32(B[:, j]), rtol=0,
                           atol=1e-6 * np.abs(X32).max())


def test_supernodal_fuzz_compact(rng):
    for t in range(6):
        n = int(rng.integers(5, 120))
        dens = float(rng.uniform(0.05, 0.5))
        A, S = random_spd(rng, n, density=dens)
        F = SupernodalCholesky(_port(A), order=int(rng.integers(0, 2)),
                               device="cpu")
        assert F.factor(), (t, n, dens)
        b = rng.normal(size=n)
        assert resid(S.toarray(), F.solve(b), b) < 1e-13


# ------------------------------------------------------ contracts
def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        SupernodalCholesky(_port(csc_from_dense(np.eye(8))))


def test_cholsol_supernodal_engine(rng, monkeypatch):
    monkeypatch.setenv("TPUSPARSE_CHOL_ENGINE", "supernodal")
    n = 40
    A, S = random_spd(rng, n, density=0.2)
    b = rng.normal(size=n)
    ok, x = tpusparse_torch.cholsol(1, _port(A), b, device="cpu")
    assert ok
    assert resid(S.toarray(), x, b) < 1e-13
