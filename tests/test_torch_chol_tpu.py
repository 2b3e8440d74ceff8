"""tpusparse_torch fixed-tile Cholesky (TpuCholesky) against the JAX
package, on the CPU: the copied planner bit for bit, the factor from the
same initial pool (against JAX's unrolled, scan and Pallas factor
paths), the solve on the same factor, the updown, and twins of the
tests/test_device_chol.py and updown tests.  Inputs are made with numpy
seeds and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.core import csc_from_dense
from tpusparse.device import chol_tpu as jct
import tpusparse_torch
from tpusparse_torch.core import CSCMatrix as TCSC
from tpusparse_torch.device import chol_tpu as tct
from tpusparse_torch.device.chol_plan import plan_cholesky
from tpusparse_torch.device.chol_tpu import TpuCholesky
from helpers import random_spd, resid


def _port(A):
    """The port's CSCMatrix from the arrays of the JAX package's."""
    return TCSC(A.m, A.n, A.indptr, A.indices, A.data)


def _grid3d(g):
    import scipy.sparse as sp
    from tpusparse.core import CSCMatrix
    n = g ** 3
    ex = -np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0
    ey = -np.ones(n - g)
    ey[((np.arange(g, n) // g) % g) == 0] = 0
    ez = -np.ones(n - g * g)
    S = sp.diags([7.0 * np.ones(n), ex, ex, ey, ey, ez, ez],
                 [0, 1, -1, g, -g, g * g, -g * g], format="csc")
    S.sort_indices()
    return CSCMatrix(n, n, S.indptr, S.indices, S.data), S


def _not_spd():
    d = np.eye(6)
    d[4, 4] = -1.0
    return csc_from_dense(d), None


# name -> (matrix maker, planner kwargs): the matrices of
# tests/test_device_chol.py, the updown tests and test_supernodal.py's
# tiled comparisons, under the settings their tests use
CASES = {
    "spd20_b8": (lambda r: random_spd(r, 20, 0.15), dict(order=1, block=8)),
    "spd48_b16": (lambda r: random_spd(r, 48, 0.15),
                  dict(order=1, block=16)),
    "spd100_b32": (lambda r: random_spd(r, 100, 0.15),
                   dict(order=1, block=32)),
    "spd24_o0_b8": (lambda r: random_spd(r, 24, 0.25),
                    dict(order=0, block=8)),
    "spd64_b16": (lambda r: random_spd(r, 64, 0.1), dict(order=1, block=16)),
    "spd60_default": (lambda r: random_spd(r, 60, 0.2), dict(order=1)),
    "spd80_b8": (lambda r: random_spd(r, 80, 0.1), dict(order=1, block=8)),
    "spd60_o0_b16": (lambda r: random_spd(r, 60, 0.15),
                     dict(order=0, block=16)),
    "spd200_b32": (lambda r: random_spd(r, 200, 0.05),
                   dict(order=1, block=32)),
    "grid8_o0_b64": (lambda r: _grid3d(8), dict(order=0, block=64)),
    "not_spd": (lambda r: _not_spd(), dict(order=0, block=8)),
}
# the factor/solve parity cases (each costs JAX compiles of its own)
FACTOR_CASES = ["spd24_o0_b8", "spd48_b16", "spd100_b32"]


def _assert_plans_equal(p, q):
    for f in ("n", "B", "nb", "flops_true", "flops_padded", "lnz"):
        assert getattr(p, f) == getattr(q, f), f
    for f in ("perm", "pinv"):
        a, b = getattr(p, f), getattr(q, f)
        assert (a is None) == (b is None), f
        assert a is None or np.array_equal(a, b), f
    assert np.array_equal(p.diag_id, q.diag_id)
    for f in ("off_ids", "off_rows", "upd_dst", "upd_a", "upd_b"):
        a, b = getattr(p, f), getattr(q, f)
        assert len(a) == len(b) == p.nb, f
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert p.pool_init.dtype == q.pool_init.dtype
    assert np.array_equal(p.pool_init, q.pool_init)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_parity(rng, name):
    build, kw = CASES[name]
    A, _ = build(rng)
    _assert_plans_equal(plan_cholesky(_port(A), **kw),
                        jct.plan_cholesky(A, **kw))


def test_plan_parity_env_block(rng, monkeypatch):
    monkeypatch.setenv("TPUSPARSE_BLOCK", "16")
    A, _ = random_spd(rng, 70, 0.1)
    p = plan_cholesky(_port(A), order=1)
    assert p.B == 16
    _assert_plans_equal(p, jct.plan_cholesky(A, order=1))


_JAX = {}


def _jax_factored(name, A, kw):
    """The JAX package's unrolled-path factor object for one case, made
    once per module (every test rebuilds the same matrix from seed 0)."""
    if name not in _JAX:
        F = jct.TpuCholesky(A, use_scan=False, **kw)
        assert F.factor()
        _JAX[name] = F
    return _JAX[name]


def _setup(name, rng):
    build, kw = CASES[name]
    A, S = build(rng)
    d = S.toarray() if S is not None else None
    return d, A, kw


def _err(pool_t, pool_j):
    pj = np.asarray(pool_j, np.float64)
    return np.abs(tct.pool_to_numpy(pool_t) - pj).max(), np.abs(pj).max()


@pytest.mark.parametrize("name", FACTOR_CASES)
def test_factor_parity(rng, name):
    """Port factor vs JAX ``_factor_fn`` from the same initial pool: f32
    with another summation order, 1e-4 of max|L|."""
    d, A, kw = _setup(name, rng)
    J = _jax_factored(name, A, kw)
    T = TpuCholesky(_port(A), device="cpu", **kw)
    assert T.factor()
    err, top = _err(T.pool, J.pool)
    assert err <= 1e-4 * top


@pytest.mark.parametrize("pallas", [False, True])
def test_factor_parity_scan(rng, monkeypatch, pallas):
    """The same against JAX's scan factor (``_factor_fn_scan``), and once
    with its Pallas chol and trsm kernels in interpret mode."""
    if pallas:
        monkeypatch.setenv("TPUSPARSE_PALLAS_CHOL", "1")
        monkeypatch.setenv("TPUSPARSE_PALLAS_TRSM", "1")
    A, _ = random_spd(rng, 80, 0.1)
    kw = dict(order=1, block=8)
    jct._SCAN_CACHE.clear()
    try:
        plan = jct.plan_cholesky(A, **kw)
        Lj = np.asarray(jax.jit(jct._factor_fn_scan(plan))(
            jnp.asarray(plan.pool_init)))
    finally:
        jct._SCAN_CACHE.clear()
    T = TpuCholesky(_port(A), device="cpu", **kw)
    assert T.factor()
    err, top = _err(T.pool, Lj)
    assert err <= 1e-4 * top


@pytest.mark.parametrize("name", FACTOR_CASES)
def test_solve_parity_on_jax_factor(rng, name):
    """The port's solve on the JAX factor (load_pool): f32 solve within
    1e-5 of JAX's, refined solve equal to the host engine's and at the
    reference residual grade."""
    from tpusparse.numeric import cholsol as host_cholsol
    d, A, kw = _setup(name, rng)
    J = _jax_factored(name, A, kw)
    T = TpuCholesky(_port(A), device="cpu", **kw)
    T.load_pool(np.asarray(J.pool))
    b = rng.normal(size=A.n)
    xt, xj = T._solve_f32(b), J._solve_f32(b)
    assert np.abs(xt - xj).max() <= 1e-5 * np.abs(xj).max()
    x = T.solve(b)
    ok, xh = host_cholsol(1, A, b.copy())
    assert ok
    assert np.allclose(xh, x, atol=1e-9)
    assert resid(d, x, b) < 1e-12


def test_pool_round_trip(rng):
    pool = rng.normal(size=(3, 8, 8)).astype(np.float32)
    t = tct.pool_from_numpy(pool, "cpu")
    t[0, 0, 0] = 7.0                 # never shares memory with the input
    assert pool[0, 0, 0] != 7.0
    assert np.array_equal(tct.pool_to_numpy(t)[1:], pool[1:])


# ------------------------------------------- twins of test_device_chol.py
@pytest.mark.parametrize("n,block", [(20, 8), (48, 16), (100, 32)])
def test_tpu_cholesky_solve(rng, n, block):
    A, S = random_spd(rng, n, density=0.15)
    F = TpuCholesky(_port(A), order=1, block=block, device="cpu")
    assert F.factor()
    b = 1.0 + np.arange(n) / n
    x = F.solve(b)
    assert resid(S.toarray(), x, b) < 1e-13


def test_tpu_cholesky_factor_matches_host(rng):
    n = 24
    A, S = random_spd(rng, n, density=0.25)
    F = TpuCholesky(_port(A), order=0, block=8, device="cpu")
    assert F.factor()
    plan = F.plan
    pool = tct.pool_to_numpy(F.pool)
    nbB = plan.nb * plan.B
    L = np.zeros((nbB, nbB))
    for k in range(plan.nb):
        B = plan.B
        L[k * B:(k + 1) * B, k * B:(k + 1) * B] = np.tril(
            pool[plan.diag_id[k]])
        for r, sid in zip(plan.off_rows[k], plan.off_ids[k]):
            L[r * B:(r + 1) * B, k * B:(k + 1) * B] = pool[sid]
    rec = (L @ L.T)[:n, :n]
    assert np.allclose(rec, S.toarray(), atol=1e-3)


def test_tpu_cholesky_not_spd():
    A, _ = _not_spd()
    F = TpuCholesky(_port(A), order=0, block=8, device="cpu")
    assert F.factor() is False
    with pytest.raises(ValueError):
        F.solve(np.ones(6))


def test_plan_stats(rng):
    A, S = random_spd(rng, 64, density=0.1)
    plan = plan_cholesky(_port(A), order=1, block=16)
    assert plan.lnz > 0
    assert plan.flops_padded >= plan.flops_true
    assert 0.0 <= plan.waste_ratio < 1.0


def test_refinement_reaches_reference_grade(rng):
    n = 60
    A, S = random_spd(rng, n, density=0.2)
    F = TpuCholesky(_port(A), order=1, device="cpu")
    assert F.factor()
    b = rng.normal(size=n)
    x_raw = F._solve_f32(b)
    x_ref = F.solve(b)
    assert resid(S.toarray(), x_ref, b) < 1e-14
    assert resid(S.toarray(), x_ref, b) <= resid(S.toarray(), x_raw, b)


@pytest.mark.parametrize("order,block", [(1, 8), (0, 16)])
def test_solve_many_batched(rng, order, block):
    """All k right-hand sides in one pass: each column refined to the
    reference grade, and the f32 pass equal to k single solves."""
    n = 60
    A, S = random_spd(rng, n, density=0.15)
    F = TpuCholesky(_port(A), order=order, block=block, device="cpu")
    assert F.factor()
    B = rng.normal(size=(n, 5))
    X = F.solve_many(B)
    for j in range(5):
        assert resid(S.toarray(), X[:, j], B[:, j]) < 1e-13
    X32 = F._solve_f32_many(B)
    for j in range(5):
        assert np.allclose(X32[:, j], F._solve_f32(B[:, j]), rtol=0,
                           atol=1e-6 * np.abs(X32).max())


# ------------------------------------------------------------- updown
def _demo3_w(F, rng):
    """demo3's recipe: w with the pattern of column n/2 of the factor,
    mapped back to original coordinates."""
    n = F.plan.n
    L, _ = F._extract_L()
    k = n // 2
    seg = L.indices[L.indptr[k]:L.indptr[k + 1]]
    wperm = np.zeros(n)
    wperm[seg] = rng.random(seg.size)
    w = np.zeros(n)
    if F.plan.perm is not None:
        w[F.plan.perm] = wperm
    else:
        w = wperm
    return w


def test_extract_L_matches_jax(rng):
    A, _ = random_spd(rng, 24, density=0.3)
    J = jct.TpuCholesky(A, order=1, block=8)
    assert J.factor()
    T = TpuCholesky(_port(A), order=1, block=8, device="cpu")
    T.load_pool(np.asarray(J.pool))
    Lt, st = T._extract_L()
    Lj, sj = J._extract_L()
    assert np.array_equal(Lt.indptr, Lj.indptr)
    assert np.array_equal(Lt.indices, Lj.indices)
    assert np.array_equal(Lt.data, Lj.data)
    assert st == sj


def test_device_updown_roundtrip(rng):
    n = 24
    A, S = random_spd(rng, n, density=0.3)
    F = TpuCholesky(_port(A), order=1, block=8, device="cpu")
    assert F.factor()
    b = rng.normal(size=n)
    w = _demo3_w(F, rng)
    d0 = S.toarray()
    assert F.updown(+1, w)
    x = F.solve(b)
    assert resid(d0 + np.outer(w, w), x, b) < 1e-13
    assert F.updown(-1, w)
    x = F.solve(b)
    assert resid(d0, x, b) < 1e-13


def test_updown_matches_jax(rng):
    """The port's updown on the JAX factor against JAX's updown: the
    updated pools within 1e-4 of max|L| (f32, the same recurrence)."""
    n = 40
    A, S = random_spd(rng, n, density=0.2)
    J = jct.TpuCholesky(A, order=1, block=8)
    assert J.factor()
    T = TpuCholesky(_port(A), order=1, block=8, device="cpu")
    T.load_pool(np.asarray(J.pool))
    w = _demo3_w(T, rng)
    for sigma in (+1, -1):
        assert J.updown(sigma, w)
        assert T.updown(sigma, w)
        err, top = _err(T.pool, J.pool)
        assert err <= 1e-4 * top
        assert np.array_equal(T.A.toscipy().toarray(),
                              J.A.toscipy().toarray())


def test_device_updown_stays_on_device(rng, monkeypatch):
    """updown never takes the factor to the host: _extract_L must not
    run, and the pool stays a tensor on the factor's device."""
    d = rng.normal(size=(24, 24)) * (rng.random((24, 24)) < 0.4)
    d = d @ d.T + 24 * np.eye(24)
    A = csc_from_dense(d)
    F = TpuCholesky(_port(A), order=1, block=8, device="cpu")
    assert F.factor()

    def boom(self):
        raise AssertionError("factor left the device")

    monkeypatch.setattr(TpuCholesky, "_extract_L", boom)
    monkeypatch.setattr(tct, "pool_to_numpy", boom)
    w = np.zeros(24)
    k = 12
    widx = [i for i in range(24) if d[i, k] != 0 and i >= k]
    w[widx] = rng.random(len(widx))
    assert F.updown(+1, w)
    assert isinstance(F.pool, torch.Tensor)
    assert F.pool.device == torch.device("cpu")
    dn = d + np.outer(w, w)
    b = rng.normal(size=24)
    x = F.solve(b)
    assert resid(dn, x, b) < 1e-12


def test_device_updown_failure():
    A = csc_from_dense(np.eye(4))
    F = TpuCholesky(_port(A), order=0, block=8, device="cpu")
    assert F.factor()
    old = F.pool.clone()
    assert not F.updown(-1, np.array([2.0, 0.0, 0.0, 0.0]))
    assert torch.equal(F.pool, old)                  # old factor kept
    with pytest.raises(ValueError):
        TpuCholesky(_port(A), order=0, block=8, device="cpu").updown(
            1, np.ones(4))


# ------------------------------------------------------ contracts
@pytest.mark.parametrize("block", [12, 136, 256])
def test_block_outside_kernel_range_raises(rng, block):
    """No silent fallback: a B the kernels do not take raises in the
    constructor, before any device is touched, with or without a card."""
    A, _ = random_spd(rng, 40, 0.2)
    with pytest.raises(ValueError, match=r"multiple of 8 in \[8, 128\]"):
        TpuCholesky(_port(A), order=1, block=block, device="cuda")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        TpuCholesky(_port(csc_from_dense(np.eye(8))))


def test_cholsol_tiled(rng):
    A, S = random_spd(rng, 50, 0.15)
    b = rng.normal(size=50)
    ok, x = tpusparse_torch.cholsol(1, _port(A), b, engine="tiled",
                                    device="cpu")
    assert ok
    assert resid(S.toarray(), x, b) < 1e-12
