"""tpusparse_torch SuperscanLU against the JAX package, on the CPU: a twin
of every SuperscanLU test of tests/test_superscan_lu.py (same inputs, same
limits), the copied planner with lu_extras bit for bit, the factor from
the same matrix (pools within a tolerance, pivots identical), and the
port's solve on the JAX factor.  Inputs are made with numpy seeds and
handed to both packages; every port call runs on device="cpu"."""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpusparse.core import CSCMatrix, csc_from_dense
from tpusparse.device import superscan_lu as jlu
from tpusparse_torch.core import CSCMatrix as TCSC
from tpusparse_torch.device import superscan, superscan_lu as tlu
from tpusparse_torch.device.superscan_lu import SuperscanLU
from tpusparse_torch.utils.profiling import recording
from helpers import resid
from test_torch_superscan import _assert_plans_equal


def _port(A):
    """The port's CSCMatrix from the arrays of the JAX package's."""
    return TCSC(A.m, A.n, A.indptr, A.indices, A.data)


def _lu(A, **kw):
    return SuperscanLU(_port(A), device="cpu", **kw)


def _unsym(rng, n, dens=0.2, dom=1.0):
    d = rng.normal(size=(n, n)) * (rng.random((n, n)) < dens)
    d += np.diag(np.abs(d).sum(1) + dom)
    return d, csc_from_dense(d)


def _convdiff(g, weak_cols=()):
    """Unsymmetric 2D convection-diffusion; ``weak_cols`` get a ~zero
    diagonal (tests/test_superscan_lu.py::_convdiff)."""
    n = g * g
    main = 4.0 * np.ones(n)
    ex_lo = np.full(n - 1, -1.6)
    ex_lo[np.arange(1, n) % g == 0] = 0
    ex_hi = np.full(n - 1, -0.4)
    ex_hi[np.arange(1, n) % g == 0] = 0
    ey = -np.ones(n - g)
    A = sp.diags([main, ex_hi, ex_lo, ey, ey], [0, 1, -1, g, -g],
                 format="csc").tolil()
    for i in weak_cols:
        A[i, i] = 1e-12
    A = A.tocsc()
    A.sort_indices()
    return CSCMatrix(n, n, A.indptr, A.indices, A.data), A


def _growth_bomb(n=96, K=40, tiny=1e-9):
    """Tiny diagonal, unit entries K rows below it: uncontained growth
    without matching (tests/test_superscan_lu.py::_growth_bomb)."""
    d = np.eye(n) * tiny
    for i in range(n - K):
        d[i + K, i] = 1.0
    d[0, n - 1] = 0.5
    return d, csc_from_dense(d)


# ------------------------------------------- twins of test_superscan_lu.py
@pytest.mark.parametrize("n,dens", [(15, 0.5), (60, 0.2), (150, 0.07)])
def test_fuzz_unsymmetric(rng, n, dens):
    d, A = _unsym(rng, n, dens)
    F = _lu(A, order=1, wmax=16, tau=0.9, small_w=4)
    assert F.factor()
    b = rng.normal(size=n)
    assert resid(d, F.solve(b), b) < 1e-12


def test_banded_unsymmetric(rng):
    n = 600
    d = np.zeros((n, n))
    for off, scale in [(0, 4.0), (1, -1.0), (-1, -2.0),
                       (12, -0.7), (-12, -0.4)]:
        m = n - abs(off)
        v = scale * (1.0 + 0.3 * rng.random(m))
        d[np.arange(m) + max(0, -off), np.arange(m) + max(0, off)] = v
    F = _lu(csc_from_dense(d), order=1, max_segments=8)
    assert F.factor()
    b = rng.normal(size=n)
    assert resid(d, F.solve(b), b) < 1e-12


def test_matches_host_lu(rng):
    from tpusparse.numeric import lusol
    d, A = _unsym(rng, 80, 0.15)
    b = rng.normal(size=80)
    ok, xh = lusol(1, A, b.copy())
    assert ok
    F = _lu(A, order=1, wmax=16)
    assert F.factor()
    assert np.allclose(xh, F.solve(b), atol=1e-9)


def test_tiny_pivot_perturbation_healed_by_refinement(rng):
    d, A = _unsym(rng, 40, 0.3)
    d[7, 7] = 1e-13
    F = _lu(csc_from_dense(d), order=0, wmax=16)
    assert F.factor()
    b = rng.normal(size=40)
    assert resid(d, F.solve(b, refine_iters=8), b) < 1e-10


def test_metrics(rng):
    d, A = _unsym(rng, 50, 0.3)
    F = _lu(A, order=1, wmax=16)
    m = F.metrics().values
    assert m["lu_engine"] == "superscan_lu"
    assert m["lu_flops_true"] > 0 and m["lu_segments"] >= 1
    J = jlu.SuperscanLU(A, order=1, wmax=16).metrics().values
    assert m == J                       # same plan, no factor yet


def test_device_resident_solve_never_downloads():
    M, S = _convdiff(16)
    F = _lu(M, order=1, wmax=32)
    assert F.factor()
    b = 1.0 + np.arange(M.n) / M.n
    x = F.solve(b)
    assert F._LU_host is None
    assert resid(S.toarray(), x, b) < 1e-13


def test_device_solve_matches_host_extract(rng):
    M, S = _convdiff(12)
    F = _lu(M, order=1, wmax=16)
    assert F.factor()
    b = rng.normal(size=M.n)
    assert np.allclose(F._solve_f32(b), F._solve_f32_host(b), rtol=1e-4,
                       atol=1e-5)


@pytest.mark.parametrize("weak", [[100], [100, 101], [50, 200, 350]])
def test_within_panel_pivoting_rescues_weak_diagonal(weak):
    M, S = _convdiff(24, weak)
    b = 1.0 + np.arange(M.n) / M.n
    d = S.toarray()
    F0 = _lu(M, order=1, wmax=32, tol=0.0, match=False)
    if F0.factor():
        try:
            r0 = resid(d, F0.solve(b), b)
        except ValueError:
            r0 = np.inf
    else:
        assert F0.growth_exceeded
        r0 = np.inf
    F1 = _lu(M, order=1, wmax=32, tol=1.0, match=False)
    assert F1.factor()
    r1 = resid(d, F1.solve(b), b)
    assert r1 < 1e-12
    assert r0 > 1e3 * r1


def test_pivoted_factorization_product():
    """P_panel * C = L U on the extracted factor (pivoted coordinates)."""
    from tpusparse_torch.core.ops import permute
    from tpusparse_torch.core.perm import pinv
    M, S = _convdiff(8, [0, 1])
    n = M.n
    F = _lu(M, order=0, wmax=8, tol=1.0, match=False)
    assert F.factor()
    L, U, pglob = F.extract_LU()
    C = permute(F._B, pinv(F.plan.perm), F.plan.perm, values=True)
    Cd, Ld, Ud = (m.toscipy().toarray() for m in (C, L, U))
    assert np.abs(np.triu(Ld, 1)).max() == 0
    assert np.abs(np.tril(Ud, -1)).max() == 0
    assert (pglob != np.arange(n)).sum() > 0
    assert np.abs(Cd[pglob] - Ld @ Ud).max() < 1e-4


def test_lu_panel_kernel_vs_dense():
    """lu_tiles (its plain version here) on the reference's own case."""
    from tpusparse_torch.device.kernels import lu_tiles
    D = np.random.default_rng(3).normal(size=(4, 16, 16)).astype(np.float32)
    D[:, 0, 0] = 1e-9
    F, P = (t.numpy() for t in lu_tiles(torch.from_numpy(D), 1e-20, 1.0))
    for u in range(4):
        L = np.tril(F[u], -1) + np.eye(16)
        U = np.triu(F[u])
        assert np.abs(P[u] @ D[u] - L @ U).max() < 1e-4
        assert (P[u].sum(0) == 1).all() and (P[u].sum(1) == 1).all()


def test_solve_many_consistent():
    M, S = _convdiff(10)
    F = _lu(M, order=1, wmax=16)
    assert F.factor()
    for seed in (0, 1):
        b = np.random.default_rng(seed).normal(size=M.n)
        assert resid(S.toarray(), F.solve(b), b) < 1e-13


def test_solve_many_device_resident(rng):
    M, S = _convdiff(10)
    F = _lu(M, order=1, wmax=16)
    assert F.factor()
    B = rng.normal(size=(M.n, 3))
    X = F.solve_many(B)
    assert F._LU_host is None
    for j in range(3):
        assert resid(S.toarray(), X[:, j], B[:, j]) < 1e-13


def test_growth_detection_fails_fast():
    d, A = _growth_bomb()
    F = _lu(A, order=1, tol=1.0, match=False)
    assert not F.factor()
    assert F.growth_exceeded
    assert F.growth > 1e6
    assert F.pools is None
    assert F.metrics().values["lu_growth"] == F.growth


def test_moderate_growth_not_flagged(rng):
    d, A = _unsym(rng, 120, 0.1)
    F = _lu(A, order=1)
    assert F.factor()
    assert not F.growth_exceeded
    assert F.growth is not None and F.growth < 1e3


# ------------------------------------------------------ parity with JAX
# name -> (matrix maker, SuperscanLU kwargs)
CASES = {
    "fuzz60": (lambda rng: _unsym(rng, 60, 0.2)[1],
               dict(order=1, wmax=16, tau=0.9, small_w=4)),
    "fuzz150_o0": (lambda rng: _unsym(rng, 150, 0.07)[1],
                   dict(order=0, wmax=16, small_w=4, max_segments=6)),
    "weak_tol1": (lambda rng: _convdiff(24, [100, 101])[0],
                  dict(order=1, wmax=32, tol=1.0, match=False)),
    "weak_tol0.001": (lambda rng: _convdiff(12, [0, 1, 30])[0],
                      dict(order=0, wmax=16, tol=0.001, match=False)),
    "matched": (lambda rng: _convdiff(16, [40, 41, 100])[0],
                dict(order=1, wmax=32, tol=1.0, match=True)),
    "convdiff_tol0": (lambda rng: _convdiff(16)[0],
                      dict(order=1, wmax=32, tol=0.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_parity_with_lu_extras(rng, monkeypatch, name):
    """The port's LU plan, tgtu included, bit for bit against JAX's
    plan_superscan(..., lu_extras=True); also the initial pools."""
    make, kw = CASES[name]
    A = make(rng)
    T, J = _lu(A, **kw), jlu.SuperscanLU(A, **kw)
    assert any("tgtu" in a for s in T.plan.segments for a in s.xs.values())
    _assert_plans_equal(T.plan, J.plan, monkeypatch)
    for pw in T.plan.pool_init:
        assert np.array_equal(T._Lp0[pw], J._Lp0[pw])
        assert np.array_equal(T._Up0[pw], J._Up0[pw])
    assert (T._match_p is None) == (J._match_p is None)
    if T._match_p is not None:
        assert np.array_equal(T._match_p, J._match_p)


# the cases whose factor pivots inside some panel
PIVOTING = {"weak_tol1", "weak_tol0.001", "matched"}
_JAX = {}


def _jax_factored(name, A, kw):
    if name not in _JAX:
        F = jlu.SuperscanLU(A, **kw)
        assert F.factor()
        _JAX[name] = F
    return _JAX[name]


def _p_slots(plan, pools):
    """Each panel's one-hot P, from the U pool's diagonal slot."""
    return [np.asarray(pools[("U", pl.pool)])[pl.rbase:pl.rbase + pl.W,
                                                :pl.W]
            for pl in plan.panels]


@pytest.mark.parametrize("name", sorted(CASES))
def test_factor_parity(rng, name):
    """Port factor vs JAX factor of the same matrix: every P slot
    identical; L and U pools over the real rows within
    n * 2^-23 * max|A| * 8, f32 with another order of summation (XLA's
    fused multiply-adds, the blocked no-pivot LU at tol = 0, the scatter
    order) through up to n eliminations; the growth metric too."""
    make, kw = CASES[name]
    A = make(rng)
    J = _jax_factored(name, A, kw)
    T = _lu(A, **kw)
    assert T.factor()
    slots = _p_slots(T.plan, T.pools)
    for p, q in zip(slots, _p_slots(J.plan, J.pools)):
        assert np.array_equal(p, q)
    pivoted = any((p != np.eye(p.shape[0])).any() for p in slots)
    assert pivoted == (name in PIVOTING)
    tol = A.n * 2.0 ** -23 * T._maxabs * 8
    for (side, pw), v in T.pools.items():
        r = T.plan.pool_rows[pw]
        err = np.abs(v.numpy()[:r] - np.asarray(J.pools[(side, pw)])[:r])
        assert err.max(initial=0.0) <= tol, (side, pw)
    assert T.growth == pytest.approx(J.growth, rel=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_parity_on_jax_factor(rng, name):
    """load_pools takes the JAX factor: the port's f32 solve within 1e-5
    of JAX's, its refined solve equal to JAX's and to the host engine's
    at the reference grade; solve_many and solve_host agree."""
    from tpusparse.numeric import lusol as host_lusol
    make, kw = CASES[name]
    A = make(rng)
    J = _jax_factored(name, A, kw)
    T = _lu(A, **kw)
    T.load_pools({k: np.asarray(v) for k, v in J.pools.items()})
    b = rng.normal(size=A.n)
    xt, xj = T._solve_f32(b), J._solve_f32(b)
    assert np.abs(xt - xj).max() <= 1e-5 * np.abs(xj).max()
    x = T.solve(b)
    assert np.allclose(x, J.solve(b), atol=1e-9)
    ok, xh = host_lusol(1, A, b.copy())
    assert ok and np.allclose(xh, x, atol=1e-9)
    assert resid(A.toscipy().toarray(), x, b) < 1e-12
    assert np.allclose(T.solve_host(b), x, atol=1e-9)
    X = T.solve_many(np.stack([b, 2 * b], axis=1))
    assert np.allclose(X[:, 0], x, atol=1e-9)


def test_load_pools_factor_matches_own_factor(rng):
    """load_pools of the port's own factor (round trip through numpy)
    solves as the factor it came from."""
    make, kw = CASES["weak_tol1"]
    A = make(rng)
    T = _lu(A, **kw)
    assert T.factor()
    U = _lu(A, **kw)
    U.load_pools({k: v.numpy() for k, v in T.pools.items()})
    b = rng.normal(size=A.n)
    assert np.array_equal(U._solve_f32(b), T._solve_f32(b))


@pytest.mark.parametrize("name", ["fuzz60", "matched"])
def test_refactor_is_bit_for_bit(rng, name):
    """Three factors of one SuperscanLU leave the pools of a fresh
    object's one factor, bit for bit; the factor schedule crosses to the
    device once (``sched_uploads`` 1, then 0) and the scattered A's host
    pools are left as they were."""
    make, kw = CASES[name]
    A = make(rng)
    T = _lu(A, **kw)
    def host():
        return {(side, pw): v for side, pools in (("L", T._Lp0),
                                                  ("U", T._Up0))
                for pw, v in pools.items()}
    init = {k: v.copy() for k, v in host().items()}
    ups = []
    for _ in range(3):
        if T.pools is not None:
            for v in T.pools.values():
                v.add_(1.0)        # the next factor starts afresh
        with recording() as rec:
            assert T.factor()
        root, = [s for s in rec if s.parent == -1]
        ups.append(root.counts["sched_uploads"])
    assert ups == [1, 0, 0] and T._factor_sched.host is None
    U = _lu(A, **kw)
    assert U.factor()
    assert T.pools.keys() == U.pools.keys()
    for k in U.pools:
        assert torch.equal(T.pools[k], U.pools[k]), k
    assert all(np.array_equal(v, init[k]) for k, v in host().items())


def test_each_trsm_phase_is_two_kernel_solves(rng, monkeypatch):
    """Every trsm phase of a step calls trsm_tiles_batched twice (U_D^T
    for the L rows, the unit L_D for the U rows), and the panel LU
    lu_tiles_pool once per chol phase, on the CPU as on the card."""
    calls = {"trsm": 0, "lu": 0}
    trsm, lu = tlu.trsm_tiles_batched, tlu.lu_tiles_pool

    def spy_trsm(L, X):
        calls["trsm"] += 1
        return trsm(L, X)

    def spy_lu(L, U, dbase, W, eps, tol):
        calls["lu"] += 1
        return lu(L, U, dbase, W, eps, tol)
    monkeypatch.setattr(tlu, "trsm_tiles_batched", spy_trsm)
    monkeypatch.setattr(tlu, "lu_tiles_pool", spy_lu)
    make, kw = CASES["weak_tol1"]
    F = _lu(make(rng), **kw)
    assert F.factor()

    def phases(kind):
        return sum(s.hi - s.lo for s in F.plan.segments
                   for k, a in s.xs.items()
                   if k[0] == kind and next(iter(a.values())).shape[1])
    assert calls == {"trsm": 2 * phases("trsm"), "lu": phases("chol")}


def _convdiff_3d(g):
    """Unsymmetric 3D convection-diffusion (bench.py::conv_diff_3d, the
    LU leg's matrix)."""
    n = g ** 3
    ex_lo, ex_hi = -1.4 * np.ones(n - 1), -0.6 * np.ones(n - 1)
    ex_lo[np.arange(1, n) % g == 0] = 0.0
    ex_hi[np.arange(1, n) % g == 0] = 0.0
    ey = -np.ones(n - g)
    ey[((np.arange(g, n) // g) % g) == 0] = 0.0
    ez = -np.ones(n - g * g)
    A = sp.diags([7.0 * np.ones(n), ex_hi, ex_lo, ey, ey, ez, ez],
                 [0, 1, -1, g, -g, g * g, -g * g], format="csc")
    A.sort_indices()
    return CSCMatrix(n, n, A.indptr, A.indices, A.data)


def _tile_by_tile(L, U, dbase, W, eps, tol):
    """The CUDA kernel's in-place semantics, serialised: the first slot
    of each run of equal dbase values reads its tile from the pool and
    writes F and P back before the next tile is read; the other slots of
    a run (padded slots on the pad block) store nothing."""
    from tpusparse_torch.device.kernels import lu_tiles_ref
    pw = L.shape[1]
    bases = dbase.tolist()
    for t, b in enumerate(bases):
        if t and b == bases[t - 1]:
            continue
        Fk, Pk = lu_tiles_ref(L[b:b + W, :W][None].contiguous(), eps, tol)
        L[b:b + W] = torch.nn.functional.pad(Fk[0], (0, pw - W))
        U[b:b + W] = torch.nn.functional.pad(Pk[0], (0, pw - W))


@pytest.mark.parametrize("shared", ["identity", "random"])
def test_tile_by_tile_factors_a_shared_tile_once(rng, shared):
    """Slots that share a tile stand next to each other, and the kernel
    stores the first of them only: the shared tile becomes its LU once,
    as lu_tiles_pool's plain version leaves it, whether or not the tile
    is its own LU."""
    from tpusparse_torch.device.kernels import lu_tiles_pool_ref
    pw, W, pad = 32, 16, 96
    L = torch.from_numpy(rng.normal(size=(pad + pw, pw)).astype(np.float32))
    if shared == "identity":
        L[pad:] = torch.eye(pw)
    U = torch.from_numpy(rng.normal(size=L.shape).astype(np.float32))
    dbase = torch.tensor([0, 40, pad, pad, pad])
    L1, U1, L2, U2 = L.clone(), U.clone(), L.clone(), U.clone()
    _tile_by_tile(L1, U1, dbase, W, 1e-7, 1.0)
    lu_tiles_pool_ref(L2, U2, dbase, W, 1e-7, 1.0)
    assert torch.equal(L1, L2) and torch.equal(U1, U2)
    assert torch.equal(L1[pad:pad + W, :W], torch.eye(W)) == (
        shared == "identity")


@pytest.mark.parametrize("order,tol", [(0, 1.0), (1, 0.001)])
def test_panel_in_place_matches_gather_path(monkeypatch, order, tol):
    """lu_tiles_pool's plain version (the gather path: every tile read
    before any is written) and the kernel's in-place semantics tile by
    tile give the same pools bit for bit on a g=10 LU plan, pad block and
    padded slots included."""
    A = _convdiff_3d(10)
    pools, padded = [], 0
    for in_place in (False, True):
        with monkeypatch.context() as m:
            if in_place:
                m.setattr(tlu, "lu_tiles_pool", _tile_by_tile)
            F = _lu(A, order=order, tol=tol)
            assert F.factor()
        pools.append({k: v.clone() for k, v in F.pools.items()})
    for seg in F.plan.segments:                 # padded slots that run
        for key, a in seg.xs.items():
            lad = seg.ladders.get(key)
            for step in range(seg.hi - seg.lo if key[0] == "chol" else 0):
                bs = (a["dbase"].shape[1] if lad is None
                      else lad[int(seg.lvls[key][step])])
                padded += int((a["dbase"][step, :bs]
                               == F.plan.pool_rows[key[1]]).sum())
    assert padded > 0
    assert pools[1].keys() == pools[0].keys()
    for k, v in pools[0].items():
        assert torch.equal(v, pools[1][k]), k


def _masked_delta(pools, key, a, c):
    """The update deltas as the port computed them on the plan's own
    schedule: -1 masked by ``torch.where`` after a clamped gather, dU
    zeroed on the diagonal block (tgtu < 0)."""
    kind, pd, ps, H, Wd, Ws = key
    Ld, Ud = pools[("L", pd)][:, :Wd], pools[("U", pd)][:, :Wd]
    src, l0i = a["src"], a["l0"]
    ms, m0 = (src >= 0)[..., None], (l0i >= 0)[..., None]
    s, t = src.clamp(min=0), l0i.clamp(min=0)
    l1 = torch.where(ms, Ld[s], c.zero)
    u1 = torch.where(ms, Ud[s], c.zero)
    u0 = torch.where(m0, Ud[t], c.zero)
    l0 = torch.where(m0, Ld[t], c.zero)
    dL = torch.bmm(l1, u0.mT)
    dU = torch.where((a["tgtu"] >= 0)[..., None], torch.bmm(u1, l0.mT),
                     c.zero)
    return dL, dU


def _masked_apply(pools, key, a, dL, dU):
    """The scatter-adds at clamped targets, the plan's own schedule."""
    kind, pd, ps, H, Wd, Ws = key
    for side, tgt, delta in (("L", a["tgt"], dL), ("U", a["tgtu"], dU)):
        acc = pools[(side, ps)]
        if kind == "upds":
            flat = tgt.clamp(min=0)[:, :, None] * ps + a["cmap"][:, None, :]
            acc.view(-1).index_add_(0, flat.reshape(-1), delta.reshape(-1),
                                    alpha=-1)
        else:
            acc[:, :Ws].index_add_(0, tgt.clamp(min=0).reshape(-1),
                                   delta.reshape(-1, Ws), alpha=-1)


def _padding(plan) -> dict:
    """{(kind, what): entries} of the plan's update keys: padded src, l0
    and tgt, and real rows of the diagonal block (tgt >= 0 > tgtu)."""
    got = {}
    for seg in plan.segments:
        for key, a in seg.xs.items():
            if key[0] not in ("upd", "upds"):
                continue
            for what, n in (("src", (a["src"] < 0).sum()),
                            ("l0", (a["l0"] < 0).sum()),
                            ("tgt", (a["tgt"] < 0).sum()),
                            ("diag", ((a["tgt"] >= 0)
                                      & (a["tgtu"] < 0)).sum())):
                got[(key[0], what)] = got.get((key[0], what), 0) + int(n)
    return got


@pytest.mark.parametrize("tol", [1.0, 0.0])
def test_resolved_update_matches_masked_path(tol):
    """The factor on the schedule whose padding is resolved at pack time
    leaves every row of every pool but the update phase's dump row bit
    for bit as the masked path leaves it on the plan's own schedule (a
    g=10 LU plan whose upd and upds keys both hold padded src, l0 and tgt
    entries and diagonal-block rows); the zero row is still 0, no entry
    of the packed schedule is negative, ``remapped`` counts the -1s
    redirected, and extract_LU and the f32 solve give what the masked
    pools give."""
    A = _convdiff_3d(10)
    F = _lu(A, order=1, tol=tol)
    pad = _padding(F.plan)
    assert all(pad.get((kind, what), 0) > 0 for kind in ("upd", "upds")
               for what in ("src", "l0", "tgt", "diag")), pad
    minus = sum(int((a[nm] < 0).sum()) for s in F.plan.segments
                for k, a in s.xs.items() if k[0] in ("upd", "upds")
                for nm in ("src", "l0", "tgt", "tgtu"))
    with recording() as rec:
        assert F.factor()
    up = [s for s in rec if s.name == "superscan_lu.factor.upload"]
    assert [s.counts.get("remapped") for s in up] == [minus, None]
    ph = tlu._phases(F._eps(), F.tol)
    masked = functools.partial(superscan._upd_step, delta=_masked_delta,
                               apply=_masked_apply)
    ph = superscan._Phases(ph.name, ((ph.runs[0][0], ph.runs[0][1],
                                      masked),) + ph.runs[1:])
    pools = {(side, pw): torch.tensor(v)
             for side, host in (("L", F._Lp0), ("U", F._Up0))
             for pw, v in host.items()}
    superscan._factor(F.plan, pools, None, ph)
    assert pools.keys() == F.pools.keys()
    for k, v in pools.items():
        dump, zero = tlu._pad_rows(F.plan, k[1])
        keep = torch.ones(v.shape[0], dtype=torch.bool)
        keep[dump] = False
        assert torch.equal(F.pools[k][keep].view(torch.int32),
                           v[keep].view(torch.int32)), k
        assert torch.equal(F.pools[k][zero].view(torch.int32),
                           torch.zeros(k[1], dtype=torch.int32)), k
    assert all((v >= 0).all() for xs in F._factor_sched.scheds
               for d in xs.values() for v in d.values())
    G = _lu(A, order=1, tol=tol)
    G.load_pools({k: v.numpy() for k, v in pools.items()})
    for got, want in zip(F.extract_LU(), G.extract_LU()):
        if isinstance(want, np.ndarray):
            assert np.array_equal(got, want)
        else:
            assert np.array_equal(got.indptr, want.indptr)
            assert np.array_equal(got.indices, want.indices)
            assert np.array_equal(got.data, want.data)
    b = np.random.default_rng(3).normal(size=A.n)
    assert np.array_equal(F._solve_f32(b), G._solve_f32(b))


class _Ops(TorchDispatchMode):
    """Counts the aten ops that are not views."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind,ops", [("upd", 8), ("upds", 10)])
def test_update_pair_issues_gathers_gemms_and_scatters_only(kind, ops):
    """One update pair issues four gathers, two ``bmm`` and two
    ``index_add_`` (upds: and the two adds of its flat indices), and no
    mask, clamp or ``where``."""
    F = _lu(_convdiff_3d(10), order=1)
    assert F.factor()
    key, a = next((k, {nm: v[0] for nm, v in d.items()})
                  for xs in F._factor_sched.scheds for k, d in xs.items()
                  if k[0] == kind)
    with _Ops() as got:
        tlu._upd_apply(F.pools, key, a,
                       *tlu._upd_delta(F.pools, key, a, F._consts))
    assert len(got.ops) == ops, got.ops
    assert sorted(set(got.ops)) == sorted(
        {"aten.index.Tensor", "aten.bmm.default", "aten.index_add_.default"}
        | ({"aten.add.Tensor"} if kind == "upds" else set()))


def test_not_square_and_default_device():
    with pytest.raises(ValueError):
        SuperscanLU(TCSC(3, 4, np.zeros(5, np.int64), np.zeros(0, np.int64),
                         np.zeros(0)), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        SuperscanLU(_port(csc_from_dense(np.eye(8))))
