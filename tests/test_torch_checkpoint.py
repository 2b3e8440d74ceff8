"""tpusparse_torch.utils.checkpoint against the JAX package's, on the
CPU: twins of the checkpoint tests of tests/test_utils.py and of
tests/test_mfqr.py::test_checkpoint_roundtrip, and the cross-package
round trips: each of the five device factor kinds saved by one package
loads in the other and solves to the reference grade.  The tiled and
superscan Cholesky pools (and the LU's) come back bit for bit; the
multifrontal QR is held by its solution, since V and tau differ past a
contribution block's rank between two correct factors."""

import numpy as np
import pytest
import torch

from tpusparse.core import csc_from_dense
from tpusparse.device.chol_tpu import TpuCholesky as JTpuCholesky
from tpusparse.device.mfqr import MultifrontalQR as JMultifrontalQR
from tpusparse.device.qr_tpu import SparseQR as JSparseQR
from tpusparse.device.superscan import SuperscanCholesky as JSuperscan
from tpusparse.device.superscan_lu import SuperscanLU as JSuperscanLU
from tpusparse.utils import checkpoint as jck
from tpusparse_torch.core import CSCMatrix as TCSC
from tpusparse_torch.core.perm import ipvec, pvec
from tpusparse_torch.device.chol_tpu import TpuCholesky
from tpusparse_torch.device.mfqr import MultifrontalQR
from tpusparse_torch.device.qr_tpu import SparseQR
from tpusparse_torch.device.superscan import SuperscanCholesky
from tpusparse_torch.device.superscan_lu import SuperscanLU
from tpusparse_torch.numeric import chol, lsolve, ltsolve, qr
from tpusparse_torch.symbolic.plan import schol, sqr
from tpusparse_torch.utils import checkpoint as tck
from helpers import random_csc, random_spd, resid

SMALL = dict(wmax=16, tau=0.9, small_w=4)


def _port(A):
    return TCSC(A.m, A.n, A.indptr, A.indices, A.data)


# ------------------------------------------------------ twins, host half
def test_symbolic_roundtrip(tmp_path, rng):
    A, _ = random_spd(rng, 15, density=0.3)
    S = schol(1, _port(A))
    p = str(tmp_path / "sym.npz")
    tck.save_symbolic(p, S)
    S2 = tck.load_symbolic(p)
    assert np.array_equal(S.pinv, S2.pinv)
    assert np.array_equal(S.parent, S2.parent)
    assert np.array_equal(S.cp, S2.cp)
    assert S.lnz == S2.lnz
    S3 = jck.load_symbolic(p)              # and the JAX package reads it
    assert np.array_equal(S.pinv, S3.pinv) and S.lnz == S3.lnz


def test_numeric_roundtrip_factor_once_solve_later(tmp_path, rng):
    A, Ssp = random_spd(rng, 15, density=0.3)
    S = schol(1, _port(A))
    N = chol(_port(A), S)
    p = str(tmp_path / "num.npz")
    tck.save_numeric(p, N)
    N2 = tck.load_numeric(p)
    b = rng.normal(size=15)
    x = ipvec(S.pinv, b)
    x = lsolve(N2.L, x)
    x = ltsolve(N2.L, x)
    x = pvec(S.pinv, x)
    assert resid(Ssp.toarray(), x, b) < 1e-13
    assert np.array_equal(jck.load_numeric(p).L.data, N.L.data)


def test_qr_numeric_roundtrip(tmp_path, rng):
    A, _ = random_csc(rng, 14, 9, density=0.4)
    Sy = sqr(0, _port(A), qr=True)
    N = qr(_port(A), Sy)
    p = str(tmp_path / "qr.npz")
    tck.save_numeric(p, N)
    N2 = tck.load_numeric(p)
    assert np.allclose(N2.U.todense(), N.U.todense())
    assert np.allclose(N2.B, N.B)


# ---------------------------------------------------- twins, device half
@pytest.mark.parametrize("n,dens", [(24, 0.3), (220, 0.05)])
def test_device_chol_checkpoint(tmp_path, rng, n, dens):
    """Twins of test_device_chol_checkpoint and of its scan-path variant
    (n=220, 28 panels: the JAX package restores a scan solve there; the
    port has one solve form)."""
    A, Ssp = random_spd(rng, n, density=dens)
    F = TpuCholesky(_port(A), order=1, block=8, device="cpu")
    assert F.factor()
    p = str(tmp_path / "dev.npz")
    tck.save_chol_factor(p, F)
    F2 = tck.load_chol_factor(p, _port(A), device="cpu")
    assert torch.equal(F2.pool, F.pool)
    assert F2.metrics().values == F.metrics().values
    b = rng.normal(size=n)
    x = F2.solve(b)
    assert resid(Ssp.toarray(), x, b) < 1e-13


def test_superscan_factor_checkpoint(rng, tmp_path):
    n = 40
    d = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.3)
    d = d @ d.T + n * np.eye(n)
    A = _port(csc_from_dense(d))
    F = SuperscanCholesky(A, order=1, device="cpu", **SMALL)
    assert F.factor()
    pth = str(tmp_path / "ss.npz")
    tck.save_superscan_factor(pth, F)
    F2 = tck.load_superscan_factor(pth, A, device="cpu", order=1, **SMALL)
    b = rng.normal(size=n)
    x = F2.solve(b)          # no re-factorization needed
    assert resid(d, x, b) < 1e-12
    with pytest.raises(ValueError):            # another plan is refused
        tck.load_superscan_factor(pth, A, device="cpu", order=0, **SMALL)


def test_superscan_lu_factor_checkpoint(rng, tmp_path):
    n = 40
    d = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.3)
    d = d + n * np.eye(n)                 # unsymmetric, diag-dominant
    A = _port(csc_from_dense(d))
    F = SuperscanLU(A, order=1, device="cpu", **SMALL)
    assert F.factor()
    pth = str(tmp_path / "sslu.npz")
    tck.save_superscan_lu_factor(pth, F)
    # JAX's keys, and pools of the plan's shapes (the factor's scratch
    # rows lie inside them)
    J = JSuperscanLU(csc_from_dense(d), order=1, **SMALL)
    assert J.factor()
    jck.save_superscan_lu_factor(str(tmp_path / "jax.npz"), J)
    z, zj = np.load(pth), np.load(str(tmp_path / "jax.npz"))
    assert sorted(z.files) == sorted(zj.files)
    for side in ("L", "U"):
        for pw, v in F.plan.pool_init.items():
            key = f"pool_{side}_{pw}"
            assert z[key].shape == zj[key].shape == v.shape, key
    F2 = tck.load_superscan_lu_factor(pth, A, device="cpu", order=1,
                                      **SMALL)
    assert F2.perturbed == F.perturbed
    b = rng.normal(size=n)
    x = F2.solve(b)          # no re-factorization needed
    assert resid(d, x, b) < 1e-12


def test_sparse_qr_factor_checkpoint(rng, tmp_path):
    m, n = 60, 30
    d = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.4)
    d[np.arange(n), np.arange(n)] += 5.0
    A = _port(csc_from_dense(d))
    F = SparseQR(A, device="cpu", **SMALL)
    assert F.rank_ok
    pth = str(tmp_path / "ssqr.npz")
    tck.save_sparse_qr_factor(pth, F)
    F2 = tck.load_sparse_qr_factor(pth, A, device="cpu", **SMALL)
    b = rng.normal(size=m)
    x = F2.solve_ls(b)
    xref = np.linalg.lstsq(d, b, rcond=None)[0]
    assert np.allclose(x, xref, atol=1e-8)


def _tall(rng, m, n, dens=0.1):
    d = rng.normal(size=(m, n)) * (rng.random((m, n)) < dens)
    d[np.arange(n), np.arange(n)] += 3.0
    return d, csc_from_dense(d)


def test_mfqr_checkpoint_roundtrip(rng, tmp_path):
    """Twin of test_mfqr.py::test_checkpoint_roundtrip, and a file
    without the rank_ok field restored through _check_rank."""
    d, A = _tall(rng, 100, 45, 0.12)
    F = MultifrontalQR(_port(A), device="cpu")
    assert F.factor()
    b = rng.normal(size=100)
    x0 = F.solve_ls(b)
    p = str(tmp_path / "mfqr.npz")
    tck.save_mfqr_factor(p, F)
    G = tck.load_mfqr_factor(p, _port(A), device="cpu")
    x1 = G.solve_ls(b)
    assert np.abs(x0 - x1).max() < 1e-12
    # mismatched matrix is rejected
    d2, A2 = _tall(rng, 100, 45, 0.2)
    with pytest.raises(ValueError):
        tck.load_mfqr_factor(p, _port(A2), device="cpu")
    z = dict(np.load(p))
    del z["rank_ok"]
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **z)
    assert tck.load_mfqr_factor(old, _port(A), device="cpu").rank_ok
    z = {k: (np.zeros_like(v) if k.startswith("pool_") else v)
         for k, v in z.items()}
    np.savez_compressed(old, **z)
    assert not tck.load_mfqr_factor(old, _port(A), device="cpu").rank_ok


# ------------------------------------------------- across the packages
def _spd(rng, n=60, dens=0.2):
    d = rng.normal(size=(n, n)) * (rng.random((n, n)) < dens)
    d = d @ d.T + n * np.eye(n)
    return d, csc_from_dense(d)


def _unsym(rng, n=60, dens=0.2):
    d = rng.normal(size=(n, n)) * (rng.random((n, n)) < dens)
    return d + n * np.eye(n), None


def _ls_grade(d, x, b):
    """max|A'(A x - b)| / (||A||_1^2 max|x| + max|b| ||A||_1): the
    normal-equation residual of a least-squares solution."""
    nr = d.T @ (d @ x - b)
    n1 = np.abs(d).sum(0).max()
    return np.abs(nr).max() / (n1 * (n1 * np.abs(x).max()
                                     + np.abs(b).max()))


# kind -> (matrix, JAX factor, port factor, saver name, loader name,
#          loader kwargs, pools of a factor as {key: numpy})
KINDS = {
    "tiled": (_spd, lambda A: JTpuCholesky(A, order=1, block=8),
              lambda A: TpuCholesky(A, order=1, block=8, device="cpu"),
              "chol_factor", {},
              lambda F: {0: np.asarray(F.pool)}),
    "superscan": (_spd, lambda A: JSuperscan(A, order=1, **SMALL),
                  lambda A: SuperscanCholesky(A, order=1, device="cpu",
                                              **SMALL),
                  "superscan_factor", dict(order=1, **SMALL),
                  lambda F: {k: np.asarray(v) for k, v in F.pools.items()}),
    "superscan_lu": (_unsym, lambda A: JSuperscanLU(A, order=1, **SMALL),
                     lambda A: SuperscanLU(A, order=1, device="cpu",
                                           **SMALL),
                     "superscan_lu_factor", dict(order=1, **SMALL),
                     lambda F: {k: np.asarray(v)
                                for k, v in F.pools.items()}),
    "mfqr": (lambda rng: _tall(rng, 90, 50, 0.1), JMultifrontalQR,
             lambda A: MultifrontalQR(A, device="cpu"), "mfqr_factor", {},
             None),
    "sparse_qr": (lambda rng: _tall(rng, 90, 50, 0.1),
                  lambda A: JSparseQR(A, **SMALL),
                  lambda A: SparseQR(A, device="cpu", **SMALL),
                  "sparse_qr_factor", SMALL,
                  lambda F: {k: np.asarray(v)
                             for k, v in F.F.pools.items()}),
}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cross_package_checkpoint(rng, tmp_path, kind, direction):
    make, jax_f, port_f, what, kw, pools_of = KINDS[kind]
    d, _ = make(rng)
    A = csc_from_dense(d)
    p = str(tmp_path / f"{kind}.npz")
    if direction == "jax_to_port":
        F = jax_f(A)
        assert kind == "sparse_qr" or F.factor()
        getattr(jck, f"save_{what}")(p, F)
        G = getattr(tck, f"load_{what}")(p, _port(A), device="cpu", **kw)
    else:
        F = port_f(_port(A))
        assert kind == "sparse_qr" or F.factor()
        getattr(tck, f"save_{what}")(p, F)
        G = getattr(jck, f"load_{what}")(p, A, **kw)
    if pools_of is not None:
        saved, got = pools_of(F), pools_of(G)
        assert saved.keys() == got.keys()
        assert all(np.array_equal(saved[k], got[k]) for k in saved)
    if kind in ("mfqr", "sparse_qr"):
        b = rng.normal(size=A.m)
        x = G.solve_ls(b)
        xref = np.linalg.lstsq(d, b, rcond=None)[0]
        assert _ls_grade(d, x, b) <= 1e-12
        assert np.abs(x - xref).max() <= 1e-10 * np.abs(xref).max()
        assert np.abs(x - F.solve_ls(b)).max() <= 1e-10 * np.abs(x).max()
    else:
        b = rng.normal(size=A.n)
        assert resid(d, G.solve(b), b) <= 1e-12
