"""tpusparse_torch MultifrontalQR against the JAX package, on the CPU.

- the plan: ``plan_mfqr`` of the port bit for bit the JAX planner's, on
  the matrices of tests/test_mfqr.py and on the QR leg of BENCH_r05
  (bench.py::sparse_ls_problem(16384, 8192), whose fields are asserted);
- the factor: pools and taus against the JAX factor in both of its
  dispatches (group and bucket), within 1e-6 * ||A||_1 (f32 rounding;
  the contribution blocks are summed with ``index_add_`` and the panels
  reduced in another order).  The matrices there are dense enough that
  every front's contribution block has full rank: where a block is rank
  deficient its Householder continuation is rounding noise, so the
  pools of two correct factors differ there, while R does not.  So on
  sparse matrices R's rows (and Q^T b's R coordinates) are compared up
  to the sign of each row, which the Householder rule takes from a
  diagonal that may be a rounding-level value;
- the launches: one panel (H2) per panel of 8 columns of every (level,
  bucket) batch, one reflector application (H3) per io entry per pass;
- ``extract_R``: R on its true pattern (``plan.rnz`` entries), the
  pools' R entry for entry, against a plain f64 QR up to row signs;
- twins of every test of tests/test_mfqr.py (same inputs, same limits)
  except ``test_group_dispatch_program_count``, which counts the JAX
  package's compiled programs (the port has no compiler), and
  ``test_checkpoint_roundtrip``, which waits for a port of the
  checkpoint module (tpusparse/utils/checkpoint.py).  The twin of
  ``test_group_vs_bucket_dispatch_parity`` holds the port's one dispatch
  against both of the JAX package's.

Inputs are made with numpy and handed to both packages; every port call
passes device="cpu", so the kernel wrappers run their plain versions."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bench import sparse_ls_problem
from benchmark.matrices import poisson_ls
from tpusparse.core import csc_from_dense
from tpusparse.core.ops import norm1
from tpusparse.device.mfqr import MultifrontalQR as JaxMultifrontalQR
from tpusparse.device.mfqr import plan_mfqr as jax_plan_mfqr
from tpusparse_torch.core import CSCMatrix as TCSC
from tpusparse_torch.device import dense, mfqr
from tpusparse_torch.device.mfqr import MultifrontalQR, plan_mfqr

# BENCH_r05's mfqr row (bench.py::sparse_ls_problem(16384, 8192), seed 5)
BENCH_QR = dict(m=16384, n=8192, nnz=62450, fronts=2031, levels=60,
                flops_true=520378040, flops_padded=848629624, waste=0.3868,
                panels=2366, io=220)


def _port(A):
    """The port's CSCMatrix from the arrays of the JAX package's."""
    return TCSC(A.m, A.n, A.indptr, A.indices, A.data)


def _tall(rng, m, n, dens=0.1, scale=None):
    d = rng.normal(size=(m, n)) * (rng.random((m, n)) < dens)
    d[np.arange(n), np.arange(n)] += 3.0
    if scale is not None:
        d = d * scale[None, :]
    return d, csc_from_dense(d)


def _mfqr(A, **kw):
    return MultifrontalQR(_port(A), device="cpu", **kw)


def _panels(plan) -> int:
    """H2 launches of one factor: the panels of 8 columns of every
    (level, bucket) batch."""
    return sum(-(-min(b) // 8) for lf in plan.level_factor for b in lf)


def _io(plan) -> int:
    """H3 launches of one Q^T or Q pass: one per (level, bucket) io
    entry."""
    return sum(len(li) for li in plan.level_io)


# ------------------------------------------------------------------ plan
def _assert_plans_equal(P, J):
    for k in ("m", "n", "nlevels", "ysize", "ncomp", "flops_true",
              "flops_padded", "rnz", "vnz"):
        assert getattr(P, k) == getattr(J, k), k
    for k in ("q", "col2sn", "pass_rows", "pass_slots"):
        assert np.array_equal(getattr(P, k), getattr(J, k)), k
    assert P.buckets == J.buckets
    assert P.bucket_count == J.bucket_count
    for b in J.buckets:
        assert np.array_equal(P.pool_init[b], J.pool_init[b]), b
    for name in ("level_factor", "level_assemble", "level_disassemble",
                 "level_io", "level_rsolve"):
        for lp, lj in zip(getattr(P, name), getattr(J, name)):
            assert list(lp) == list(lj), name
            for k in lj:
                vp, vj = lp[k], lj[k]
                vp, vj = (vp, vj) if isinstance(vj, tuple) else ((vp,), (vj,))
                assert all(np.array_equal(a, b) for a, b in zip(vp, vj)), \
                    (name, k)
    assert len(P.fronts) == len(J.fronts)
    for fp, fj in zip(P.fronts, J.fronts):
        for k in ("sid", "c0", "w", "nrow_real", "nrow_eff", "kstar", "cr",
                  "level", "bucket", "slot", "comp_off", "children",
                  "child_base"):
            assert getattr(fp, k) == getattr(fj, k), k
        assert np.array_equal(fp.od, fj.od)
        assert np.array_equal(fp.rows_a, fj.rows_a)


@pytest.mark.parametrize("m,n,dens,seed", [
    (120, 70, 0.1, 0), (80, 40, 0.15, 1), (250, 100, 0.1, 2),
    (300, 60, 0.2, 3), (64, 64, 0.1, 4), (400, 160, 0.08, 5),
    (17, 9, 0.4, 6)])
def test_plan_bit_equal(m, n, dens, seed):
    _, A = _tall(np.random.default_rng(seed), m, n, dens)
    _assert_plans_equal(plan_mfqr(_port(A)), jax_plan_mfqr(A))


def test_plan_bench_leg_bit_equal():
    """BENCH_r05's QR leg: the port's plan is the JAX plan, and its
    fields are the row's."""
    A = sparse_ls_problem(16384, 8192)
    P = plan_mfqr(_port(A))
    _assert_plans_equal(P, jax_plan_mfqr(A))
    got = dict(m=P.m, n=P.n, nnz=int(A.indptr[-1]), fronts=len(P.fronts),
               levels=P.nlevels, flops_true=P.flops_true,
               flops_padded=P.flops_padded, waste=round(P.waste_ratio, 4),
               panels=_panels(P), io=_io(P))
    assert got == BENCH_QR


# ---------------------------------------------------------------- factor
@pytest.fixture(scope="module")
def generic():
    """A matrix whose fronts all have full-rank contribution blocks, and
    the JAX package's factors of it in both dispatches."""
    d, A = _tall(np.random.default_rng(11), 160, 64, 0.35)
    jax_f = {}
    for dispatch in ("group", "bucket"):
        J = JaxMultifrontalQR(A, dispatch=dispatch)
        assert J.factor()
        jax_f[dispatch] = J
    return d, A, jax_f


@pytest.mark.parametrize("dispatch", ["group", "bucket"])
def test_pools_and_taus_match_jax(generic, dispatch):
    d, A, jax_f = generic
    J = jax_f[dispatch]
    F = _mfqr(A)
    assert F.factor() and F.rank_ok
    tol = 1e-6 * norm1(A)
    for b in J.plan.buckets:
        assert np.abs(F.pools[b].numpy() - np.asarray(J.pools[b])).max() \
            < tol, b
        assert np.abs(F.taus[b].numpy() - np.asarray(J.taus[b])).max() \
            < 1e-5, b


@pytest.mark.parametrize("dispatch", ["group", "bucket"])
def test_apply_and_solves_match_jax(generic, dispatch, rng):
    d, A, jax_f = generic
    J = jax_f[dispatch]
    F = _mfqr(A)
    assert F.factor()
    b = rng.normal(size=A.m)
    y, yj = F.apply_qt(b), J.apply_qt(b)
    assert np.abs(y - yj).max() < 1e-5 * np.abs(b).max()
    assert np.abs(F.apply_q(y) - J.apply_q(yj)).max() < 1e-5
    x, xj = F.solve_ls(b), J.solve_ls(b)
    assert np.abs(x - xj).max() < 1e-12
    assert F.last_info["ne_resid"] < 1e-14
    bm = rng.normal(size=A.n)
    assert np.abs(F.solve_minnorm(bm) - J.solve_minnorm(bm)).max() < 1e-12


def _dense_r(plan, pools):
    """R (n x n, permuted coordinates) read from the pools front by front:
    each front's pivot rows on and right of the diagonal."""
    R = np.zeros((plan.n, plan.n))
    for f in plan.fronts:
        P = np.asarray(pools[f.bucket][f.slot], np.float64)
        gcols = np.concatenate([np.arange(f.c0, f.c0 + f.w), f.od]).astype(
            int)
        for j in range(f.w):
            row = f.c0 + j
            keep = gcols >= row
            R[row, gcols[keep]] = P[j, np.flatnonzero(keep)]
    return R


def _signed_r(plan, pools):
    """``_dense_r``, each row scaled to a nonnegative diagonal."""
    R = _dense_r(plan, pools)
    s = np.where(np.diag(R) < 0, -1.0, 1.0)
    return R * s[:, None], s


def test_r_rows_match_jax_up_to_sign(rng):
    """On a sparse matrix whose fronts have rank-deficient contribution
    blocks (the pools differ there by O(1)), R agrees with the JAX
    factor's up to row signs, and so do Q^T b's R coordinates; the
    solves agree to f64 grade."""
    _, A = _tall(np.random.default_rng(0), 120, 70)
    J = JaxMultifrontalQR(A, dispatch="bucket")
    F = _mfqr(A)
    assert J.factor() and F.factor()
    assert max(np.abs(F.pools[b].numpy() - np.asarray(J.pools[b])).max()
               for b in J.plan.buckets) > 0.1
    Rj, sj = _signed_r(J.plan, {b: np.asarray(v)
                                for b, v in J.pools.items()})
    Rp, sp_ = _signed_r(F.plan, {b: v.numpy() for b, v in F.pools.items()})
    assert np.abs(Rp - Rj).max() < 1e-6 * norm1(A)
    b = rng.normal(size=A.m)
    n = A.n
    assert np.abs(sp_ * F.apply_qt(b)[:n] - sj * J.apply_qt(b)[:n]).max() \
        < 1e-5 * np.abs(b).max()
    assert np.abs(F.solve_ls(b) - J.solve_ls(b)).max() < 1e-12


def test_launches_per_factor_and_pass(monkeypatch):
    """One qr_panel per panel of 8 columns of every (level, bucket)
    batch, one qr_apply per io entry per pass: the counts chip_smoke.py
    asserts on the card."""
    calls = {"panel": 0, "apply": 0}
    panel, apply_ = dense.qr_panel, mfqr.qr_apply

    def count_panel(*a):
        calls["panel"] += 1
        return panel(*a)

    def count_apply(*a):
        calls["apply"] += 1
        return apply_(*a)

    monkeypatch.setattr(dense, "qr_panel", count_panel)
    monkeypatch.setattr(mfqr, "qr_apply", count_apply)
    _, A = _tall(np.random.default_rng(5), 400, 160, 0.08)
    F = _mfqr(A)
    assert F.factor()
    assert calls["panel"] == _panels(F.plan) > 0
    F.apply_qt(np.ones(A.m))
    assert calls["apply"] == _io(F.plan) > 0
    F.apply_q(np.ones(F.plan.ysize))
    assert calls["apply"] == 2 * _io(F.plan)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, A = _tall(np.random.default_rng(0), 30, 12)
    with pytest.raises(RuntimeError):
        MultifrontalQR(_port(A))


# ----------------------------------------------- twins of test_mfqr.py
def test_q_roundtrip_and_orthogonality(rng):
    d, A = _tall(rng, 120, 70)
    F = _mfqr(A)
    assert F.factor()
    b = rng.normal(size=120)
    y = F.apply_qt(b)
    assert abs(np.linalg.norm(y) / np.linalg.norm(b) - 1.0) < 1e-5
    b2 = F.apply_q(y)
    assert np.abs(b - b2).max() < 1e-5


def test_qta_is_triangular(rng):
    d, A = _tall(rng, 80, 40, 0.15)
    F = _mfqr(A)
    assert F.factor()
    Aq = d[:, F.plan.q]
    for j in [0, 13, 39]:
        y = F.apply_qt(Aq[:, j])
        assert np.linalg.norm(y[j + 1:]) < 1e-4 * max(
            np.linalg.norm(y), 1.0)


def test_rtr_equals_ata(rng):
    d, A = _tall(rng, 90, 50, 0.12)
    F = _mfqr(A)
    assert F.factor()
    R = _dense_r(F.plan, F.pools)
    Aq = d[:, F.plan.q]
    assert np.abs(R.T @ R - Aq.T @ Aq).max() < 1e-4


# ------------------------------------------------------------- extract_R
def _extracted(F) -> np.ndarray:
    """``extract_R()`` as a dense array, after its exact checks: n x n,
    ``plan.rnz`` entries, upper triangular, rows increasing in each
    column."""
    R = F.extract_R()
    n = F.plan.n
    assert (R.m, R.n, R.nnz) == (n, n, F.plan.rnz)
    cols = np.repeat(np.arange(n), np.diff(R.indptr))
    assert (R.indices <= cols).all()
    assert (np.diff(R.indices)[np.diff(cols) == 0] > 0).all()
    D = np.zeros((n, n))
    D[R.indices, cols] = R.data
    return D


def test_extract_r_is_the_pools_r(rng):
    """On ``test_rtr_equals_ata``'s matrix, ``extract_R()`` is the R that
    its loop reads from the pools, entry for entry."""
    _, A = _tall(rng, 90, 50, 0.12)
    F = _mfqr(A)
    assert F.factor()
    assert np.array_equal(_extracted(F), _dense_r(F.plan, F.pools))


@pytest.mark.parametrize("g", [6, 8, 10])
def test_extract_r_on_the_regularized_poisson(g):
    """``extract_R()`` of the QR cell's matrix (``benchmark.matrices``)
    at a small grid: a plain f64 QR of A(:, q) up to row signs,
    R^T R = A_q^T A_q, the loop's R on its pattern bit for bit and within
    rounding off it (amalgamated positions that cancel in exact
    arithmetic), and ``solve_ls`` at f64 grade against
    ``numpy.linalg.lstsq``."""
    m, n, indptr, indices, data = poisson_ls.build({"grid": g, "alpha": 0.5},
                                                    None)
    d = sp.csc_matrix((data, indices, indptr), shape=(m, n)).toarray()
    F = MultifrontalQR(TCSC(m, n, indptr, indices, data), device="cpu")
    assert F.factor()
    R = _extracted(F)
    Aq = d[:, F.plan.q]
    nrm = np.abs(d).sum(axis=0).max()
    Rref = torch.linalg.qr(torch.from_numpy(Aq), mode="r")[1].numpy()
    sign = np.sign(np.diag(R))[:, None] * np.sign(np.diag(Rref))[:, None]
    assert np.abs(R * sign - Rref).max() < 1e-6 * nrm
    assert np.abs(R.T @ R - Aq.T @ Aq).max() < 1e-6 * nrm * nrm
    loop = _dense_r(F.plan, F.pools)
    on = R != 0
    assert np.array_equal(loop[on], R[on])
    assert np.abs(loop[~on]).max() < 1e-7 * nrm
    b = np.random.default_rng(g).normal(size=m)
    xref, *_ = np.linalg.lstsq(d, b, rcond=None)
    assert np.abs(F.solve_ls(b) - xref).max() < 1e-12
    assert F.last_info["ne_resid"] < 1e-14


def test_ls_matches_lstsq(rng):
    d, A = _tall(rng, 250, 100)
    F = _mfqr(A)
    assert F.factor()
    b = rng.normal(size=250)
    x = F.solve_ls(b)
    xref, *_ = np.linalg.lstsq(d, b, rcond=None)
    assert np.abs(x - xref).max() < 1e-12
    assert F.last_info["ne_resid"] < 1e-14


def test_minnorm_matches_pinv(rng):
    d, A = _tall(rng, 150, 60, 0.15)
    dw = d.T
    F = _mfqr(A)
    assert F.factor()
    b = rng.normal(size=60)
    x = F.solve_minnorm(b)
    assert np.abs(dw @ x - b).max() < 1e-12
    xr = np.linalg.pinv(dw) @ b
    assert np.abs(x - xr).max() < 1e-10


def test_ill_conditioned_ls(rng):
    scale = np.logspace(0, -4, 60)
    d, A = _tall(rng, 300, 60, 0.2, scale=scale)
    assert np.linalg.cond(d) > 1e4
    F = _mfqr(A)
    assert F.factor()
    b = rng.normal(size=300)
    x = F.solve_ls(b, refine_iters=10)
    xref, *_ = np.linalg.lstsq(d, b, rcond=None)
    assert np.abs(x - xref).max() / np.abs(xref).max() < 1e-10
    assert F.last_info["ne_resid"] < 1e-13


def test_structural_rank_deficiency(rng):
    d, _ = _tall(rng, 40, 15, 0.3)
    d[:, 7] = 0.0
    F = _mfqr(csc_from_dense(d))
    assert not F.factor()
    with pytest.raises(ValueError):
        F.solve_ls(np.ones(40))


def test_numerical_rank_deficiency(rng):
    d, _ = _tall(rng, 50, 20, 0.4)
    d[:, 11] = d[:, 4]
    F = _mfqr(csc_from_dense(d))
    ok = F.factor()
    if ok:
        R = []
        for f in F.plan.fronts:
            P = F.pools[f.bucket][f.slot].numpy()
            R.extend(np.abs(np.diag(P[:f.w, :f.w])))
        assert min(R) < 1e-3


def test_empty_rows_passthrough(rng):
    d, _ = _tall(rng, 60, 25, 0.2)
    d[13, :] = 0.0
    d[44, :] = 0.0
    F = _mfqr(csc_from_dense(d))
    assert F.factor()
    assert F.plan.pass_rows.size == 2
    b = rng.normal(size=60)
    y = F.apply_qt(b)
    assert np.abs(F.apply_q(y) - b).max() < 1e-5
    x = F.solve_ls(b)
    xref, *_ = np.linalg.lstsq(d, b, rcond=None)
    assert np.abs(x - xref).max() < 1e-12


def test_square_consistent(rng):
    d, A = _tall(rng, 64, 64, 0.1)
    F = _mfqr(A)
    assert F.factor()
    xstar = rng.normal(size=64)
    x = F.solve_ls(d @ xstar)
    assert np.abs(x - xstar).max() < 1e-11


def test_plan_accounting(rng):
    d, A = _tall(rng, 200, 90, 0.08)
    plan = plan_mfqr(_port(A))
    assert plan.flops_true > 0
    assert plan.flops_padded >= plan.flops_true
    assert 0.0 <= plan.waste_ratio < 1.0
    cols = sorted(c for f in plan.fronts
                  for c in range(f.c0, f.c0 + f.w))
    assert cols == list(range(90))
    rows = sorted([r for f in plan.fronts for r in f.rows_a]
                  + list(plan.pass_rows))
    assert rows == list(range(200))


def test_fuzz_many_shapes(rng):
    for seed, (m, n, dens) in enumerate(
            [(30, 12, 0.2), (55, 55, 0.1), (90, 30, 0.07),
             (41, 40, 0.15), (17, 9, 0.4)]):
        r = np.random.default_rng(seed + 100)
        d, A = _tall(r, m, n, dens)
        F = _mfqr(A)
        assert F.factor(), (m, n)
        b = r.normal(size=m)
        x = F.solve_ls(b, refine_iters=6)
        xref, *_ = np.linalg.lstsq(d, b, rcond=None)
        assert np.abs(x - xref).max() < 1e-10, (m, n)


def test_qrsol_routes_to_mfqr(rng, monkeypatch):
    import tpusparse_torch
    from tpusparse_torch.core.ops import transpose
    monkeypatch.setenv("TPUSPARSE_QR_DENSE_MAX", "100")
    monkeypatch.setenv("TPUSPARSE_QR_ENGINE", "mfqr")
    made = []

    class Seen(MultifrontalQR):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    from tpusparse_torch.device import solvers
    monkeypatch.setattr(solvers, "MultifrontalQR", Seen)
    d, A = _tall(rng, 90, 40, 0.12)
    b = rng.normal(size=90)
    ok, x = tpusparse_torch.qrsol(3, _port(A), b, device="cpu")
    assert ok and len(made) == 1
    xref, *_ = np.linalg.lstsq(d, b, rcond=None)
    assert np.abs(x - xref).max() < 1e-10
    Aw = transpose(_port(A), values=True)
    bw = rng.normal(size=40)
    ok, xw = tpusparse_torch.qrsol(3, Aw, bw, device="cpu")
    assert ok and len(made) == 2
    assert np.abs(d.T @ xw - bw).max() < 1e-10
    d2 = d.copy()
    d2[:, 5] = 0.0
    assert tpusparse_torch.qrsol(3, _port(csc_from_dense(d2)), b,
                                 device="cpu") == (False, None)


def test_metrics(rng):
    _, A = _tall(rng, 80, 40)
    F = _mfqr(A)
    F.factor()
    m = F.metrics().values
    assert m["qr_engine"] == "multifrontal"
    assert m["qr_fronts"] == len(F.plan.fronts)
    assert m["qr_waste_ratio"] == F.plan.waste_ratio >= 0.0


def test_group_vs_bucket_dispatch_parity(rng):
    """The port has one dispatch; its solves and Q agree with both of
    the JAX package's (which are bit-identical to each other)."""
    d, A = _tall(rng, 220, 90, 0.12)
    b = rng.normal(size=220)
    F = _mfqr(A)
    assert F.factor()
    x = F.solve_ls(b)
    for dispatch in ("group", "bucket"):
        J = JaxMultifrontalQR(A, dispatch=dispatch)
        assert J.factor()
        assert np.abs(x - J.solve_ls(b)).max() < 1e-12
        y = F.apply_qt(b)
        assert np.abs(F.apply_q(y) - J.apply_q(J.apply_qt(b))).max() < 1e-5
