"""tpusparse_torch's dense QR, its two kernels' plain versions, TpuQR,
SparseQR and qrsol against the JAX package, on the CPU.

- the panel (H2, ``qr_panel_ref``) and the port's ``qr_factor_partial``
  and ``blocked_qr`` against JAX's ``qr_factor_partial`` / ``blocked_qr``
  (with its ``_panel_v`` / ``_form_t``), within 2e-6 * max|M| (f32
  sums in another order), on random fronts and on corner fronts: a zero
  column (tau 0), a column whose part below the diagonal is zero with
  x0 > 0 and with x0 < 0 (tau 2 exactly and R = -x0: the JAX package's
  Householder rule, not geqrf's, which is asserted to differ there),
  zero-padded rows, kelim < C, wide fronts (Rh < C) and a last panel
  narrower than 8;
- the reflector application (H3, ``qr_apply_ref``) against JAX's
  ``qr_qt_mul_batched`` / ``qr_q_mul_batched`` and the dense
  ``qr_apply_qt`` / ``qr_apply_q``, within 2e-6 * max|z|; the CUDA
  kernel's compact-WY panel algebra written in torch ops here
  (``_panel_apply``) against both within 1e-5 relative, with a tau 0
  reflector over 1e20 entries kept the identity bit for bit;
- TpuQR and SparseQR: twins of tests/test_device_lu_qr.py:66 and :79 and
  of every test of tests/test_sparse_qr.py (same inputs, same limits);
- qrsol against the JAX package's qrsol and the host qrsol (the JAX
  package's and the port's copy) on the dense, mfqr and csne routes,
  least squares and min-norm, the condition gate, and (False, None) on a
  structurally rank-deficient matrix.

Inputs are made with numpy and handed to both packages; every port call
passes device="cpu", so the kernel wrappers run their plain versions."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from tpusparse.core import CSCMatrix, csc_from_dense
from tpusparse.device import dense as jdense
from tpusparse.device import solvers as jax_solvers
from tpusparse.device.qr_tpu import TpuQR as JaxTpuQR
from tpusparse.numeric.solvers import qrsol as jax_host_qrsol
import tpusparse_torch
from tpusparse_torch.core import CSCMatrix as TCSC
from tpusparse_torch.device import dense, solvers
from tpusparse_torch.device.kernels import (qr_apply, qr_apply_ref, qr_panel,
                                            qr_panel_ref)
from tpusparse_torch.device.qr_tpu import SparseQR, TpuQR
from tpusparse_torch.numeric import qrsol as host_qrsol
from helpers import random_csc

TOL = 2e-6          # f32, relative to the largest entry


def _port(A):
    """The port's CSCMatrix from the arrays of the JAX package's."""
    return TCSC(A.m, A.n, A.indptr, A.indices, A.data)


def _sqr(A, **kw):
    return SparseQR(_port(A), device="cpu", **kw)


_jax_partial = jax.jit(jdense.qr_factor_partial, static_argnums=(2, 3))


def _jax_factor(M, bs, kelim):
    """JAX's qr_factor_partial over a batch (P, m, n) of fronts."""
    out = [_jax_partial(jnp.asarray(F), jnp.zeros(M.shape[2], jnp.float32),
                        bs, kelim) for F in M]
    return (np.stack([np.asarray(a) for a, _ in out]),
            np.stack([np.asarray(t) for _, t in out]))


def _factor(M, bs, kelim):
    TM = torch.from_numpy(M.copy())
    T = torch.zeros((M.shape[0], M.shape[2]))
    dense.qr_factor_partial(TM, T, bs, kelim)
    return TM.numpy(), T.numpy()


def _corner_fronts():
    """(4, 12, 16) fronts: columns 0 and 1 already zero below the diagonal
    (x0 = -3, then 2: JAX gives the diagonal (3, -2) and taus (2, 2),
    geqrf (-3, 2) and (0, 0)), column 3 zero, rows 10 and 11 zero
    padding."""
    rng = np.random.default_rng(7)
    M = rng.normal(size=(4, 12, 16)).astype(np.float32)
    M[:, :, 0] = 0.0
    M[:, 0, 0] = -3.0
    M[:, 2:, 1] = 0.0
    M[:, 1, 1] = 2.0
    M[:, :, 3] = 0.0
    M[:, 10:, :] = 0.0
    M[1, 0, 0] = 4.0              # x0 > 0 in column 0 of front 1
    return M


# ------------------------------------------------------------- the panel
@pytest.mark.parametrize("P,m,C,pb", [(3, 40, 24, 8), (2, 16, 48, 8),
                                      (1, 64, 32, 16), (4, 9, 12, 5),
                                      (2, 24, 8, 8)])
def test_panel_ref_matches_jax(P, m, C, pb):
    M = np.random.default_rng(m + C).normal(size=(P, m, C)).astype(
        np.float32)
    JM, JT = _jax_factor(M, pb, pb)           # one panel, then its update
    TM = torch.from_numpy(M.copy())
    taus = torch.zeros((P, C))
    V, T = qr_panel_ref(TM, taus, 0, pb)
    scale = np.abs(JM).max()
    assert np.abs(TM.numpy()[:, :, :pb] - JM[:, :, :pb]).max() < TOL * scale
    assert np.abs(taus.numpy() - JT).max() < TOL
    for p in range(P):
        Vj = np.asarray(jdense._panel_v(jnp.asarray(JM[p]), 0, pb, m))
        Tj = np.asarray(jdense._form_t(jnp.asarray(Vj), jnp.asarray(
            JT[p, :pb])))
        assert np.abs(V[p].numpy() - Vj).max() < TOL * np.abs(Vj).max()
        assert np.abs(T[p].numpy() - Tj).max() < TOL * np.abs(Tj).max()
    # the columns past the panel are the kernel's caller's: untouched
    assert np.array_equal(TM.numpy()[:, :, pb:], M[:, :, pb:])


def test_panel_ref_rows_above_k0_untouched():
    M = np.random.default_rng(1).normal(size=(2, 30, 20)).astype(np.float32)
    TM = torch.from_numpy(M.copy())
    V, T = qr_panel_ref(TM, torch.zeros((2, 20)), 8, 6)
    assert V.shape == (2, 22, 6) and T.shape == (2, 6, 6)
    assert np.array_equal(TM.numpy()[:, :8], M[:, :8])


@pytest.mark.parametrize("P,m,n,kelim,bs", [
    (3, 40, 24, 24, 8),         # tall
    (2, 16, 48, 16, 8),         # wide (Rh < C)
    (2, 48, 32, 20, 8),         # kelim < C, last panel of 4
    (1, 64, 32, 32, 16),        # the dense TpuQR's panel width
    (2, 30, 30, 30, 8),         # square, last panel of 6
    (3, 12, 12, 12, 8)])
def test_factor_partial_matches_jax(P, m, n, kelim, bs):
    rng = np.random.default_rng(m * n + kelim)
    M = rng.normal(size=(P, m, n)).astype(np.float32)
    M[:, m - 3:, :] = 0.0                     # zero-padded rows
    JM, JT = _jax_factor(M, bs, kelim)
    TM, TT = _factor(M, bs, kelim)
    assert np.abs(TM - JM).max() < TOL * np.abs(JM).max()
    assert np.abs(TT - JT).max() < TOL


def test_corner_fronts_keep_the_jax_householder_rule():
    M = _corner_fronts()
    JM, JT = _jax_factor(M, 8, 12)
    TM, TT = _factor(M, 8, 12)
    assert np.abs(TM - JM).max() < TOL * np.abs(JM).max()
    assert np.abs(TT - JT).max() < TOL
    # below the diagonal already zero: reflected anyway, tau = 2, R = -x0
    assert (TT[:, 0] == 2.0).all() and (TT[:, 1] == 2.0).all()
    assert TM[0, 0, 0] == 3.0 and TM[1, 0, 0] == -4.0
    assert (TM[:, 1, 1] == -2.0).all()
    assert (TT[:, 3] == 0.0).all()            # a zero column: tau 0
    assert (TT[:, 10:12] == 0.0).all()        # past the real rows
    # geqrf keeps such a column (tau 0, R = x0): not the JAX factors
    QR, tau = torch.geqrf(torch.from_numpy(M[:1, :, :2].copy()))
    assert tau[0].tolist() == [0.0, 0.0]
    assert QR[0, 0, 0].item() == -3.0 and QR[0, 1, 1].item() == 2.0


def _one_reduction_panel(M, taus, k0, pb):
    """The column step of csrc/qr_panel.cu in torch ops, on the panel of
    M in place: per column one set of raw sums s[k] = sum_{r > j} M[r, j]
    M[r, k] over the panel, then every scalar from them (normx =
    sqrt(x0^2 + s[j]); w[k] = M[j, k] + s[k] / safe, by the reciprocal of
    safe as the kernel takes it; T's column j from w[:j], which is
    (V^T V)[:j, j]).  Row j is read, never summed; rows above j are not
    touched.  Returns (V, T) as qr_panel_ref does."""
    P, m, _ = M.shape
    X = M[:, k0:, k0:k0 + pb]
    mm = m - k0
    r = torch.arange(mm)
    T = torch.zeros((P, pb, pb), dtype=M.dtype)
    for j in range(pb):
        x = torch.where(r > j, X[:, :, j], torch.zeros(()))
        s = torch.bmm(x[:, None, :], X)[:, 0]             # (P, pb)
        row = X[:, j, :].clone()
        x0 = row[:, j]
        normx = torch.sqrt(x0 * x0 + s[:, j])
        alpha = torch.where(x0 >= 0, -normx, normx)
        denom = x0 - alpha
        safe = torch.where(denom == 0, torch.ones(()), denom)
        tau = torch.where(normx == 0, torch.zeros(()), (alpha - x0) / (
            torch.where(alpha == 0, torch.ones(()), alpha)))
        rinv = 1.0 / safe
        w = row + s * rinv[:, None]
        T[:, :j, j] = -tau[:, None] * torch.bmm(T[:, :j, :j],
                                                w[:, :j, None])[:, :, 0]
        T[:, j, j] = tau
        taus[:, k0 + j] = tau
        v = x[:, j + 1:] * rinv[:, None]
        X[:, j + 1:, j + 1:] -= (tau[:, None] * v)[:, :, None] * w[
            :, None, j + 1:]
        X[:, j, j + 1:] -= tau[:, None] * w[:, j + 1:]
        X[:, j, j] = x0 - tau * w[:, j]
        X[:, j + 1:, j] = v
    cols = torch.arange(pb)
    V = torch.where(r[:, None] > cols, X, torch.zeros(())) + (
        r[:, None] == cols).to(M.dtype)
    return V, T


def _one_reduction_factor(M, bs, kelim):
    """qr_factor_partial with _one_reduction_panel as its panel."""
    TM = torch.from_numpy(M.copy())
    taus = torch.zeros((M.shape[0], M.shape[2]))
    n = M.shape[2]
    for k0, pb in dense._panel_starts(kelim, bs):
        V, T = _one_reduction_panel(TM, taus, k0, pb)
        if k0 + pb < n:
            rest = TM[:, k0:, k0 + pb:]
            W = torch.bmm(V.transpose(1, 2), rest)
            rest.baddbmm_(V, torch.bmm(T.transpose(1, 2), W), alpha=-1.0)
    return TM.numpy(), taus.numpy()


@pytest.mark.parametrize("P,m,C,pb", [(3, 40, 24, 8), (2, 16, 48, 8),
                                      (1, 64, 32, 16), (4, 9, 12, 5),
                                      (2, 24, 8, 8)])
def test_one_reduction_matches_ref_and_jax(P, m, C, pb):
    """The kernel's algebra (one set of sums a column) against the plain
    version and JAX's qr_factor_partial, within 1e-5 relative."""
    M = np.random.default_rng(m + C).normal(size=(P, m, C)).astype(
        np.float32)
    JM, JT = _jax_factor(M, pb, pb)
    OM, Ot = torch.from_numpy(M.copy()), torch.zeros((P, C))
    V, T = _one_reduction_panel(OM, Ot, 0, pb)
    RM, Rt = torch.from_numpy(M.copy()), torch.zeros((P, C))
    Vr, Tr = qr_panel_ref(RM, Rt, 0, pb)
    for got, want in ((OM, RM), (Ot, Rt), (V, Vr), (T, Tr),
                      (OM[:, :, :pb], torch.from_numpy(JM[:, :, :pb])),
                      (Ot, torch.from_numpy(JT))):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert np.array_equal(OM.numpy()[:, :, pb:], M[:, :, pb:])


def test_one_reduction_keeps_the_corner_columns_exact():
    """Where the part below the diagonal is zero every raw sum is exactly
    0, so tau = 2 and R = -x0 bit for bit; a zero column gets tau 0."""
    M = _corner_fronts()
    JM, JT = _jax_factor(M, 8, 12)
    OM, OT = _one_reduction_factor(M, 8, 12)
    assert np.abs(OM - JM).max() <= 1e-5 * np.abs(JM).max()
    assert np.abs(OT - JT).max() <= 1e-5
    assert (OT[:, 0] == 2.0).all() and (OT[:, 1] == 2.0).all()
    assert OM[0, 0, 0] == 3.0 and OM[1, 0, 0] == -4.0
    assert (OM[:, 1, 1] == -2.0).all()
    assert (OT[:, 3] == 0.0).all() and (OT[:, 10:12] == 0.0).all()


def test_one_reduction_keeps_a_negative_zero_diagonal():
    """A zero column whose x0 is -0.0: row j is read, not summed, so R
    keeps the -0.0 (tau 0); the rest as the plain version has it."""
    M = np.random.default_rng(11).normal(size=(3, 12, 16)).astype(
        np.float32)
    M[:, :, 0] = 0.0
    M[:, 0, 0] = -0.0
    M[1, 5, 0] = -0.0
    OM, OT = _one_reduction_factor(M, 8, 12)
    assert np.signbit(OM[:, 0, 0]).all() and (OM[:, 0, 0] == 0.0).all()
    assert (OT[:, 0] == 0.0).all()
    RM, Rt = torch.from_numpy(M.copy()), torch.zeros((3, 16))
    dense.qr_factor_partial(RM, Rt, 8, 12)
    assert np.abs(OM - RM.numpy()).max() <= 1e-5 * RM.abs().max().item()
    assert np.abs(OT - Rt.numpy()).max() <= 1e-5


def test_blocked_qr_matches_jax():
    A = np.random.default_rng(3).normal(size=(72, 32)).astype(np.float32)
    JV, Jt = jdense.blocked_qr(jnp.asarray(A), 16)
    TV, Tt = dense.blocked_qr(torch.from_numpy(A), 16)
    assert np.abs(TV.numpy() - np.asarray(JV)).max() < TOL * np.abs(
        np.asarray(JV)).max()
    assert np.abs(Tt.numpy() - np.asarray(Jt)).max() < TOL
    b = np.random.default_rng(4).normal(size=72).astype(np.float32)
    tb = torch.from_numpy(b)
    for port, ref in (
            (dense.qr_apply_qt(TV, Tt, tb), jdense.qr_apply_qt(JV, Jt, b, 16)),
            (dense.qr_apply_q(TV, Tt, tb), jdense.qr_apply_q(JV, Jt, b, 16)),
            (dense.qr_solve_r(TV, tb), jdense.qr_solve_r(JV, b)),
            (dense.qr_solve_rt(TV, tb), jdense.qr_solve_rt(JV, b))):
        ref = np.asarray(ref)
        assert np.abs(port.numpy() - ref).max() < 1e-5 * np.abs(ref).max()


# ------------------------------------------------------------- the apply
@pytest.mark.parametrize("P,m,n,kelim", [(3, 40, 24, 24), (2, 16, 48, 16),
                                         (2, 48, 32, 20), (3, 12, 12, 12)])
def test_apply_ref_matches_jax(P, m, n, kelim):
    rng = np.random.default_rng(m + n)
    M = rng.normal(size=(P, m, n)).astype(np.float32)
    JM, JT = _jax_factor(M, 8, kelim)
    z = rng.normal(size=(P, m)).astype(np.float32)
    args = (torch.from_numpy(JM), torch.from_numpy(JT), torch.from_numpy(z),
            kelim)
    for port, jax_fn in ((dense.qr_qt_mul_batched, jdense.qr_qt_mul_batched),
                         (dense.qr_q_mul_batched, jdense.qr_q_mul_batched)):
        ref = np.asarray(jax_fn(jnp.asarray(JM), jnp.asarray(JT),
                                jnp.asarray(z), 8, kelim))
        assert np.abs(port(*args).numpy() - ref).max() < TOL * np.abs(
            ref).max()


def test_apply_ref_touches_only_its_slots():
    rng = np.random.default_rng(5)
    JM, JT = _jax_factor(rng.normal(size=(5, 20, 12)).astype(np.float32),
                         8, 12)
    pool, taus = torch.from_numpy(JM), torch.from_numpy(JT)
    z0 = torch.from_numpy(rng.normal(size=(5, 20)).astype(np.float32))
    slots = torch.tensor([3, 0])
    z = z0.clone()
    qr_apply_ref(pool, taus, slots, z, 12, True)
    assert torch.equal(z[[1, 2, 4]], z0[[1, 2, 4]])
    ref = dense.qr_qt_mul_batched(pool[slots], taus[slots], z0[slots], 12)
    assert torch.allclose(z[slots], ref)
    qr_apply_ref(pool, taus, slots, z, 12, False)       # Q Q^T = I
    assert torch.allclose(z, z0, atol=1e-5)


def _panel_apply(pool, taus, slots, z, kelim, transpose):
    """The panel step of csrc/qr_apply.cu in torch ops, in place on
    z[slots]: per panel of 8 reflectors (the last may be narrower; Q^T
    takes the panels forward, Q in reverse), V is the panel's columns
    masked to the unit lower trapezoid, with the column of a reflector
    whose tau is 0 set to 0 by a select (its stored values never enter a
    sum); w = V^T z and G = V^T V are summed once; T is formed from G's
    strict upper part and the taus as JAX's _form_t_batched forms it
    (T[j, j] = tau_j, T[:j, j] = -tau_j T[:j, :j] G[:j, j]); u = T^T w
    (Q^T) or T w (Q); z -= V u.  Rows above the panel are not touched."""
    F, t, zb = pool[slots], taus[slots], z[slots]
    P, Rh, _ = F.shape
    r = torch.arange(Rh)[:, None]
    panels = dense._panel_starts(kelim, 8)
    for k0, pb in (panels if transpose else panels[::-1]):
        cols = k0 + torch.arange(8)
        tau = torch.zeros((P, 8))
        tau[:, :pb] = t[:, k0:k0 + pb]
        chunk = torch.zeros((P, Rh, 8))
        chunk[:, :, :pb] = F[:, :, k0:k0 + pb]
        V = torch.where(r > cols, chunk, (r == cols).to(F.dtype))
        V = torch.where(tau[:, None, :] != 0, V, torch.zeros(()))
        w = torch.einsum("pri,pr->pi", V, zb)
        G = torch.einsum("pri,prj->pij", V, V)
        T = torch.zeros((P, 8, 8))
        for j in range(8):
            T[:, :j, j] = -tau[:, j, None] * torch.einsum(
                "pim,pm->pi", T[:, :j, :j], G[:, :j, j])
            T[:, j, j] = tau[:, j]
        u = torch.einsum("pji,pj->pi" if transpose else "pij,pj->pi", T, w)
        zb = zb - torch.einsum("pri,pi->pr", V, u)
    z[slots] = zb


@pytest.mark.parametrize("P,m,n,kelim", [(3, 40, 24, 24), (2, 16, 48, 16),
                                         (2, 48, 32, 20), (3, 12, 12, 12)])
def test_panel_apply_matches_ref_and_jax(P, m, n, kelim):
    """The kernel's panel algebra against the plain version (one reflector
    at a time) and JAX's compact-WY qr_qt_mul_batched / qr_q_mul_batched,
    within 1e-5 relative, both ways (kelim = 20: a last panel of 4; (16,
    48): a wide front)."""
    rng = np.random.default_rng(m + n)
    JM, JT = _jax_factor(rng.normal(size=(P, m, n)).astype(np.float32), 8,
                         kelim)
    z0 = rng.normal(size=(P, m)).astype(np.float32)
    pool, taus = torch.from_numpy(JM), torch.from_numpy(JT)
    slots = torch.arange(P)
    for transpose, jax_fn in ((True, jdense.qr_qt_mul_batched),
                              (False, jdense.qr_q_mul_batched)):
        got, ref = torch.from_numpy(z0.copy()), torch.from_numpy(z0.copy())
        _panel_apply(pool, taus, slots, got, kelim, transpose)
        qr_apply_ref(pool, taus, slots, ref, kelim, transpose)
        jax_z = torch.from_numpy(np.array(jax_fn(
            jnp.asarray(JM), jnp.asarray(JT), jnp.asarray(z0), 8, kelim)))
        for want in (ref, jax_z):
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_panel_apply_keeps_a_tau0_reflector_the_identity():
    """Columns 3 and 11 get tau 0 and 1e20 below the diagonal (their
    squares overflow f32): z comes out bit for bit as on the same factor
    with zeros there, within 1e-5 of the plain version; a front whose
    taus are all 0 leaves z exactly as it was."""
    rng = np.random.default_rng(9)
    JM, JT = _jax_factor(rng.normal(size=(3, 40, 24)).astype(np.float32), 8,
                         24)
    taus = torch.from_numpy(JT)
    taus[:, [3, 11]] = 0.0
    big, zero = torch.from_numpy(JM.copy()), torch.from_numpy(JM.copy())
    for col in (3, 11):
        big[:, col + 1:, col] = 1e20
        zero[:, col + 1:, col] = 0.0
    z0 = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    slots = torch.arange(3)
    for transpose in (True, False):
        zb, zz, zr = z0.clone(), z0.clone(), z0.clone()
        _panel_apply(big, taus, slots, zb, 24, transpose)
        _panel_apply(zero, taus, slots, zz, 24, transpose)
        qr_apply_ref(big, taus, slots, zr, 24, transpose)
        assert torch.equal(zb, zz) and torch.isfinite(zb).all()
        assert (zb - zr).abs().max() <= 1e-5 * zr.abs().max()
    z = z0.clone()
    _panel_apply(big, torch.zeros_like(taus), slots, z, 24, True)
    assert torch.equal(z, z0)


def test_panel_apply_touches_only_its_slots():
    rng = np.random.default_rng(5)
    JM, JT = _jax_factor(rng.normal(size=(5, 20, 12)).astype(np.float32),
                         8, 12)
    pool, taus = torch.from_numpy(JM), torch.from_numpy(JT)
    z0 = torch.from_numpy(rng.normal(size=(5, 20)).astype(np.float32))
    slots = torch.tensor([3, 0])
    z, zr = z0.clone(), z0.clone()
    _panel_apply(pool, taus, slots, z, 12, True)
    qr_apply_ref(pool, taus, slots, zr, 12, True)
    assert torch.equal(z[[1, 2, 4]], z0[[1, 2, 4]])
    assert (z - zr).abs().max() <= 1e-5 * zr.abs().max()
    _panel_apply(pool, taus, slots, z, 12, False)       # Q Q^T = I
    assert torch.allclose(z, z0, atol=1e-5)


def test_kernel_wrappers_check_their_arguments():
    M = torch.zeros((2, 10, 12))
    t = torch.zeros((2, 12))
    for bad in ((M.double(), t.double(), 0, 8), (M, t, 0, 17),
                (M, t, 10, 2), (M, t, 8, 8), (M, t[:1], 0, 8),
                (M.transpose(1, 2), torch.zeros((2, 10)), 0, 4)):
        with pytest.raises((ValueError, TypeError)):
            qr_panel(*bad)
    slots = torch.tensor([0])
    z = torch.zeros((2, 10))
    for bad in ((M, t, slots.int(), z, 8), (M, t, slots, z[:, :9], 8),
                (M, t, slots, z, 11), (M, t[:, :10], slots, z, 8)):
        with pytest.raises((ValueError, TypeError)):
            qr_apply(*bad, True)


# ------------------------------------------------------------- TpuQR
def test_tpu_qr_matches_jax():
    A, S = random_csc(np.random.default_rng(6), 60, 30, density=0.3)
    A = CSCMatrix.fromscipy((S + sp.eye(60, 30)).tocsc())
    J, F = JaxTpuQR(A), TpuQR(_port(A), device="cpu")
    assert F.rank_ok and (F.mpad, F.npad) == (J.mpad, J.npad)
    VR = np.asarray(J.VR)
    assert np.abs(F.VR.numpy() - VR).max() < TOL * np.abs(VR).max()
    assert np.abs(F.taus.numpy() - np.asarray(J.taus)).max() < TOL
    b = np.random.default_rng(7).normal(size=60)
    xj = J.solve_ls_f32(b)
    assert np.abs(F.solve_ls_f32(b) - xj).max() < 1e-5 * np.abs(xj).max()


def test_tpu_qr_least_squares(rng):
    m, n = 40, 17
    A, S = random_csc(rng, m, n, density=0.3)
    S2 = (S + sp.eye(m, n)).tocsc()
    A2 = _port(CSCMatrix.fromscipy(S2))
    ok, x = tpusparse_torch.qrsol(3, A2, rng.normal(size=m), device="cpu")
    assert ok
    b = rng.normal(size=m)
    ok, x = tpusparse_torch.qrsol(3, A2, b, device="cpu")
    oracle, *_ = np.linalg.lstsq(S2.toarray(), b, rcond=None)
    assert np.allclose(x, oracle, atol=1e-6)


def test_tpu_qr_min_norm(rng):
    m, n = 11, 23
    A, S = random_csc(rng, m, n, density=0.4)
    S2 = (S + sp.eye(m, n)).tocsc()
    A2 = _port(CSCMatrix.fromscipy(S2))
    b = rng.normal(size=m)
    ok, x = tpusparse_torch.qrsol(3, A2, b, device="cpu")
    assert ok
    assert np.allclose(S2.toarray() @ x, b, atol=1e-8)
    oracle = np.linalg.pinv(S2.toarray()) @ b
    assert np.allclose(x, oracle, atol=1e-6)


# ------------------------------------------- twins of test_sparse_qr.py
def _tall(rng, m, n, dens=0.1):
    d = rng.normal(size=(m, n)) * (rng.random((m, n)) < dens)
    d[np.arange(n), np.arange(n)] += 3.0
    return d, csc_from_dense(d)


def test_ls_matches_lstsq(rng):
    d, A = _tall(rng, 200, 80)
    F = _sqr(A, wmax=16, tau=0.9, small_w=4)
    assert F.rank_ok
    b = rng.normal(size=200)
    x = F.solve_ls(b)
    xref, *_ = np.linalg.lstsq(d, b, rcond=None)
    assert np.abs(x - xref).max() < 1e-9


def test_r_matches_householder_r(rng):
    d, A = _tall(rng, 60, 25, 0.3)
    F = _sqr(A, order=0, wmax=8, tau=0.9, small_w=4)
    assert F.rank_ok
    L = F.F.extract_L()
    AtA = d.T @ d
    perm = F.F.plan.perm
    Ld = np.zeros((25, 25))
    for j in range(25):
        seg = slice(L.indptr[j], L.indptr[j + 1])
        Ld[L.indices[seg], j] = L.data[seg]
    assert np.allclose(Ld @ Ld.T, AtA[np.ix_(perm, perm)], atol=1e-3)


def test_minnorm(rng):
    d, A = _tall(rng, 150, 60, 0.15)
    dw = d.T
    F = _sqr(A, wmax=16)
    assert F.rank_ok
    b = rng.normal(size=60)
    x = F.solve_minnorm(b)
    assert np.abs(dw @ x - b).max() < 1e-9
    xr = np.linalg.pinv(dw) @ b
    assert np.abs(x - xr).max() < 1e-8


def test_qrsol_routing_sparse(rng, monkeypatch):
    d, A = _tall(rng, 120, 50)
    b = rng.normal(size=120)
    monkeypatch.setenv("TPUSPARSE_QR_DENSE_MAX", "100")
    ok, x = tpusparse_torch.qrsol(3, _port(A), b, device="cpu")
    assert ok
    xref, *_ = np.linalg.lstsq(d, b, rcond=None)
    assert np.abs(x - xref).max() < 1e-9


def test_rank_deficient_flagged(rng):
    d = np.zeros((40, 10))
    d[:, :9] = rng.normal(size=(40, 9))
    d[:, 9] = d[:, 0] + d[:, 1]
    F = _sqr(csc_from_dense(d), wmax=8)
    assert not F.rank_ok
    with pytest.raises(ValueError):
        F.solve_ls(np.ones(40))


def _ill_conditioned_ls(m, n, cond, seed=1):
    S = sp.random(m, n, density=0.02,
                  random_state=np.random.RandomState(seed), format="csc")
    S = S + sp.vstack([sp.eye(n), sp.csr_matrix((m - n, n))]).tocsc()
    S = (S @ sp.diags(np.logspace(0, -np.log10(cond), n))).tocsc()
    S.sort_indices()
    return CSCMatrix(m, n, S.indptr, S.indices, S.data), S


def test_augmented_refinement_cond_1e4(rng):
    A, S = _ill_conditioned_ls(600, 240, 1e4)
    x_true = rng.normal(size=240)
    b = S @ x_true + 1e-3 * rng.normal(size=600)
    F = _sqr(A, wmax=16)
    assert F.rank_ok
    x = F.solve_ls(b)
    assert F.last_info["ne_resid"] < 1e-13
    assert F.last_info["aug_resid"] < 1e-13
    xd = np.linalg.lstsq(S.toarray(), b, rcond=None)[0]
    assert np.linalg.norm(x - xd) / np.linalg.norm(xd) < 1e-7


def test_device_resident_qr_solves(rng):
    A, S = _ill_conditioned_ls(300, 120, 10)
    b = rng.normal(size=300)
    F = _sqr(A, wmax=16)
    F.solve_ls(b)
    assert getattr(F.F, "_Lhost", None) is None


def test_cond_estimate_order_of_magnitude(rng):
    for cond in (1e2, 1e5):
        A, S = _ill_conditioned_ls(400, 150, cond, seed=2)
        est = _sqr(A, wmax=16).cond_estimate()
        true = np.linalg.cond(S.toarray())
        assert true / 30 < est < true * 30


def test_qrsol_cond_gate_falls_back_to_host(rng, monkeypatch):
    A, S = _ill_conditioned_ls(260, 100, 1e4, seed=3)
    b = rng.normal(size=260)
    monkeypatch.setenv("TPUSPARSE_QR_DENSE_MAX", "100")
    monkeypatch.setenv("TPUSPARSE_QR_COND_MAX", "100")
    ok, x = tpusparse_torch.qrsol(3, _port(A), b, device="cpu")
    assert ok
    xd = np.linalg.lstsq(S.toarray(), b, rcond=None)[0]
    assert np.linalg.norm(x - xd) / np.linalg.norm(xd) < 1e-7


def test_minnorm_augmented(rng):
    m, n = 80, 200
    S = sp.random(m, n, density=0.06,
                  random_state=np.random.RandomState(4), format="csc")
    S = S + sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))]).tocsc()
    S = S.tocsc()
    S.sort_indices()
    St = S.T.tocsc()
    At = CSCMatrix(n, m, St.indptr, St.indices, St.data)
    F = _sqr(At, wmax=16)
    b = rng.normal(size=m)
    x = F.solve_minnorm(b)
    assert np.abs(S @ x - b).max() < 1e-10
    xd = np.linalg.lstsq(S.toarray(), b, rcond=None)[0]
    assert np.linalg.norm(x) < np.linalg.norm(xd) * (1 + 1e-8)


# ----------------------------------------------------------------- qrsol
ROUTES = {"dense": {},
          "mfqr": {"TPUSPARSE_QR_DENSE_MAX": "100"},
          "csne": {"TPUSPARSE_QR_DENSE_MAX": "100",
                   "TPUSPARSE_QR_ENGINE": "csne"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("shape", ["tall", "wide"])
def test_qrsol_matches_jax_and_host(route, shape, monkeypatch):
    """Least squares (tall) or min-norm (wide): the port's qrsol against
    the JAX package's device and host qrsol and the port's host copy.
    The dense route refines an f32 solve twice (as the JAX package's):
    1e-6 there, f64 grade on the sparse routes."""
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(21)
    d, _ = _tall(rng, 120, 48, 0.12)
    if shape == "wide":
        d = d.T
    A = csc_from_dense(d)
    b = rng.normal(size=d.shape[0])
    made = []
    for name in ("MultifrontalQR", "SparseQR", "TpuQR"):
        cls = getattr(solvers, name)

        class Seen(cls):
            def __init__(self, *a, _name=name, **kw):
                super().__init__(*a, **kw)
                made.append(_name)

        monkeypatch.setattr(solvers, name, Seen)
    ok, x = tpusparse_torch.qrsol(3, _port(A), b, device="cpu")
    want = {"dense": "TpuQR", "mfqr": "MultifrontalQR", "csne": "SparseQR"}
    assert ok and made == [want[route]]
    okj, xj = jax_solvers.qrsol(3, A, b)
    okh, xh = jax_host_qrsol(3, A, b.copy())
    okp, xp = host_qrsol(3, _port(A), b.copy())
    assert okj and okh and okp
    tol = 1e-6 if route == "dense" else 1e-10
    scale = np.abs(xh).max()
    for other in (xj, xh, xp):
        assert np.abs(x - other).max() < tol * scale
    assert np.array_equal(xp, xh)


def test_qrsol_cond_gate_takes_the_host_engine(monkeypatch):
    monkeypatch.setenv("TPUSPARSE_QR_DENSE_MAX", "100")
    monkeypatch.setenv("TPUSPARSE_QR_COND_MAX", "100")
    A, S = _ill_conditioned_ls(260, 100, 1e4, seed=3)
    b = np.random.default_rng(8).normal(size=260)
    called = []

    def host(*a):
        called.append(True)
        return host_qrsol(*a)

    monkeypatch.setattr(solvers, "host_qrsol", host)
    ok, x = tpusparse_torch.qrsol(3, _port(A), b, engine="csne",
                                  device="cpu")
    assert ok and called == [True]
    xd = np.linalg.lstsq(S.toarray(), b, rcond=None)[0]
    assert np.linalg.norm(x - xd) / np.linalg.norm(xd) < 1e-7


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_qrsol_structurally_rank_deficient(route, monkeypatch):
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    d, _ = _tall(np.random.default_rng(9), 60, 25, 0.2)
    d[:, 7] = 0.0
    A = _port(csc_from_dense(d))
    assert tpusparse_torch.qrsol(3, A, np.ones(60), device="cpu") == \
        (False, None)
    assert tpusparse_torch.qrsol(3, A, np.ones(59), device="cpu") == \
        (False, None)


def test_qrsol_engine_names(monkeypatch):
    _, A = _tall(np.random.default_rng(10), 30, 12)
    with pytest.raises(ValueError):
        tpusparse_torch.qrsol(3, _port(A), np.ones(30), engine="tiled",
                              device="cpu")
    monkeypatch.setenv("TPUSPARSE_QR_ENGINE", "nope")
    with pytest.raises(ValueError):
        tpusparse_torch.qrsol(3, _port(A), np.ones(30), device="cpu")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, A = _tall(np.random.default_rng(0), 30, 12)
    for make in (lambda: TpuQR(_port(A)), lambda: SparseQR(_port(A)),
                 lambda: tpusparse_torch.qrsol(3, _port(A), np.ones(30))):
        with pytest.raises(RuntimeError):
            make()
