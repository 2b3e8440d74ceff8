"""The port's kernel wrappers on the CPU (chol tiles, trsm tiles with a
per-slot and a shared L; the pivoted LU tiles; DIA, SELL and BELL SpMV),
and the dense LU of the port's BTF solve: their plain versions
against the JAX package's kernels (Pallas in interpret mode, as the JAX
tests run them) and its XLA paths, the NaN failure contract, the launch
counters and the argument checks.
Inputs are made with numpy and handed to both.  The CUDA kernels
themselves run in chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.device.kernels.chol_tile import chol_tiles as jax_chol_tiles
from tpusparse.device.kernels.trsm_tile import \
    trsm_tiles as jax_trsm_tiles
from tpusparse.device.kernels.trsm_tile import \
    trsm_tiles_batched as jax_trsm_tiles_batched
from tpusparse_torch.device.kernels import (bell_spmv, bell_spmv_ref,
                                            chol_tiles, chol_tiles_ref,
                                            dia_spmv, dia_spmv_ref,
                                            lu_tiles, lu_tiles_pool,
                                            lu_tiles_pool_ref, lu_tiles_ref,
                                            sell_pack, sell_slab_ref,
                                            sell_spmv, sell_spmv_ref,
                                            trsm_tiles, trsm_tiles_batched,
                                            trsm_tiles_batched_ref,
                                            trsm_tiles_blocked_ref,
                                            trsm_tiles_ref)


def _spd_tiles(rng, nt, B):
    X = rng.normal(size=(nt, B, B)).astype(np.float32)
    return (np.einsum("tij,tkj->tik", X, X)
            + B * np.eye(B, dtype=np.float32)).astype(np.float32)


def _lower(rng, nt, W):
    return (np.tril(rng.normal(size=(nt, W, W)))
            + 3 * np.eye(W)).astype(np.float32)


def _rel(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


# f32 Cholesky of well-conditioned tiles: both sides are backward
# stable, so 1e-5 of max|L| covers the different summation orders
@pytest.mark.parametrize("B", [8, 16, 32])
def test_chol_ref_matches_pallas_kernel(rng, B):
    A = _spd_tiles(rng, 3, B)
    L = chol_tiles_ref(torch.from_numpy(A)).numpy()
    Lj = np.asarray(jax_chol_tiles(jnp.asarray(A)))
    assert _rel(L, Lj) <= 1e-5
    assert np.all(np.triu(L, 1) == 0)


@pytest.mark.parametrize("B", [64, 128])
def test_chol_ref_matches_jnp_cholesky(rng, B):
    # the JAX superscan chol phase's default path
    A = _spd_tiles(rng, 3, B)
    L = chol_tiles(torch.from_numpy(A)).numpy()
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    assert _rel(L, Lj) <= 1e-5


def test_chol_nan_contract(rng):
    A = _spd_tiles(rng, 4, 16)
    A[2, 5, 5] = -A[2, 5, 5]                   # tile 2 is not SPD
    L = chol_tiles(torch.from_numpy(A)).numpy()
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    low = np.tril(np.ones((16, 16), bool))
    assert not np.isfinite(L[2][low]).any()   # NaN below, zeros above,
    assert np.array_equal(np.isfinite(L[2]), np.isfinite(Lj[2]))  # as JAX
    good = [0, 1, 3]
    assert np.isfinite(L[good]).all()
    assert _rel(L[good], Lj[good]) <= 1e-5


@pytest.mark.parametrize("B,nt,bad", [(8, 11, 5), (128, 3, 1)])
def test_chol_nan_contract_middle_of_batch(rng, B, nt, bad):
    """A non-SPD tile between SPD ones, at the smallest and the largest
    tile (on the card the small tiles share a thread block)."""
    A = _spd_tiles(rng, nt, B)
    A[bad, B // 2, B // 2] = -A[bad, B // 2, B // 2]
    L = chol_tiles(torch.from_numpy(A)).numpy()
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    assert not np.isfinite(L[bad][np.tril(np.ones((B, B), bool))]).any()
    good = [t for t in range(nt) if t != bad]
    assert np.isfinite(L[good]).all()
    assert _rel(L[good], Lj[good]) <= 1e-5
    assert np.all(np.triu(L[good], 1) == 0)


def test_trsm_ref_matches_pallas_kernel(rng):
    nt, R, W = 4, 16, 32
    L, X = _lower(rng, nt, W), rng.normal(size=(nt, R, W)).astype(
        np.float32)
    Y = trsm_tiles_batched_ref(torch.from_numpy(L),
                               torch.from_numpy(X)).numpy()
    Yj = np.asarray(jax_trsm_tiles_batched(jnp.asarray(L), jnp.asarray(X)))
    assert _rel(Y, Yj) < 1e-5


@pytest.mark.parametrize("nt,R,W", [(3, 128, 128), (5, 8, 8)])
def test_trsm_ref_matches_triangular_solve(rng, nt, R, W):
    # the transpose convention of the JAX superscan trsm phase
    L, X = _lower(rng, nt, W), rng.normal(size=(nt, R, W)).astype(
        np.float32)
    Y = trsm_tiles_batched(torch.from_numpy(L), torch.from_numpy(X)).numpy()
    Yj = np.asarray(jax.lax.linalg.triangular_solve(
        jnp.asarray(L), jnp.asarray(X), left_side=False, lower=True,
        transpose_a=True))
    assert _rel(Y, Yj) < 1e-5
    # and it is the solve it claims to be: Y @ L^T == X (backward error;
    # a random triangular L is ill-conditioned, so |Y| grows with W)
    back = np.abs(Y @ np.swapaxes(L, 1, 2) - X).max()
    assert back <= 1e-5 * np.abs(Y).max() * np.abs(L).max()


# ------------------------------------------- trsm with one shared L
def test_trsm_tiles_ref_matches_pallas_kernel(rng):
    # the shape of test_device_chol.py::test_pallas_trsm_kernel
    W, R, nt = 16, 32, 3
    L, X = _lower(rng, 1, W)[0], rng.normal(size=(nt, R, W)).astype(
        np.float32)
    Y = trsm_tiles_ref(torch.from_numpy(L), torch.from_numpy(X)).numpy()
    Yj = np.asarray(jax_trsm_tiles(jnp.asarray(L), jnp.asarray(X)))
    assert _rel(Y, Yj) < 1e-5


@pytest.mark.parametrize("nt,R,W", [(3, 128, 128), (5, 8, 8)])
def test_trsm_tiles_ref_matches_triangular_solve(rng, nt, R, W):
    # the fixed-tile engine's XLA path (chol_tpu.py:276-278)
    L, X = _lower(rng, 1, W)[0], rng.normal(size=(nt, R, W)).astype(
        np.float32)
    Y = trsm_tiles(torch.from_numpy(L), torch.from_numpy(X)).numpy()
    Yj = np.asarray(jax.lax.linalg.triangular_solve(
        jnp.broadcast_to(jnp.asarray(L), (nt, W, W)), jnp.asarray(X),
        left_side=False, lower=True, transpose_a=True))
    assert _rel(Y, Yj) < 1e-5
    back = np.abs(Y @ L.T - X).max()
    assert back <= 1e-5 * np.abs(Y).max() * np.abs(L).max()
    # one shared L is the per-slot solve with L repeated
    Yb = trsm_tiles_batched(torch.from_numpy(np.repeat(L[None], nt, 0)),
                            torch.from_numpy(X)).numpy()
    assert np.array_equal(Y, Yb)


# ------------------- the CUDA kernel's arithmetic, written in torch ops
# trsm_tiles_blocked_ref walks 8-wide panels right-looking, as the Pallas
# body does, but multiplies by the diagonal's reciprocal where that
# divides, and sums each rank-8 update in its own order: 1e-5 of max|Y|
# covers the last-bit differences that the W-long recurrence carries
# along (the _lower factors are ill-conditioned: |Y| grows with W).
_BLOCKED_SHAPES = [(3, 128, 128), (5, 8, 8), (5, 40, 24), (3, 8, 120),
                   (4, 16, 32), (2, 64, 64)]


def _blocked_inputs(rng, nt, R, W, shared):
    L = _lower(rng, 1 if shared else nt, W)
    X = rng.normal(size=(nt, R, W)).astype(np.float32)
    return (L[0] if shared else L), X


@pytest.mark.parametrize("shared", [False, True], ids=["per_slot", "shared"])
@pytest.mark.parametrize("nt,R,W", _BLOCKED_SHAPES)
def test_trsm_blocked_ref_matches_pallas_kernel(rng, nt, R, W, shared):
    L, X = _blocked_inputs(rng, nt, R, W, shared)
    Y = trsm_tiles_blocked_ref(torch.from_numpy(L),
                               torch.from_numpy(X)).numpy()
    jax_fn = jax_trsm_tiles if shared else jax_trsm_tiles_batched
    Yj = np.asarray(jax_fn(jnp.asarray(L), jnp.asarray(X)))
    assert Y.shape == Yj.shape == (nt, R, W)
    assert _rel(Y, Yj) <= 1e-5


@pytest.mark.parametrize("shared", [False, True], ids=["per_slot", "shared"])
@pytest.mark.parametrize("nt,R,W", _BLOCKED_SHAPES)
def test_trsm_blocked_ref_matches_plain_versions(rng, nt, R, W, shared):
    L, X = _blocked_inputs(rng, nt, R, W, shared)
    Lt, Xt = torch.from_numpy(L), torch.from_numpy(X)
    ref = trsm_tiles_ref if shared else trsm_tiles_batched_ref
    Y = trsm_tiles_blocked_ref(Lt, Xt).numpy()
    assert _rel(Y, ref(Lt, Xt).numpy()) <= 1e-5
    assert not np.shares_memory(Y, X)           # X is left as it was
    # it is the solve it claims to be: Y @ L^T == X (backward error)
    back = np.abs(Y @ np.swapaxes(L, -1, -2) - X).max()
    assert back <= 1e-5 * np.abs(Y).max() * np.abs(L).max()


@pytest.mark.parametrize("shared", [False, True], ids=["per_slot", "shared"])
@pytest.mark.parametrize("nt,R,W", [(3, 128, 128), (5, 8, 8), (5, 40, 24)])
def test_trsm_blocked_ref_reads_lower_triangle_only(rng, nt, R, W, shared):
    L, X = _blocked_inputs(rng, nt, R, W, shared)
    Lnan = np.where(np.triu(np.ones((W, W), bool), 1), np.nan, L)
    Y = trsm_tiles_blocked_ref(torch.from_numpy(L), torch.from_numpy(X))
    Yn = trsm_tiles_blocked_ref(torch.from_numpy(Lnan.astype(np.float32)),
                                torch.from_numpy(X))
    assert torch.isfinite(Yn).all()
    assert torch.equal(Y, Yn)


@pytest.mark.parametrize("nt,R,W,bad", [(11, 8, 8, 5), (3, 128, 128, 1),
                                        (5, 40, 24, 0)])
def test_trsm_blocked_ref_nan_slot_leaves_the_others(rng, nt, R, W, bad):
    """A slot whose L is NaN (a failed chol tile) comes out non-finite;
    every other slot is bit-equal to the result without it."""
    L, X = _blocked_inputs(rng, nt, R, W, False)
    Lbad = L.copy()
    Lbad[bad] = np.nan
    Y = trsm_tiles_blocked_ref(torch.from_numpy(L), torch.from_numpy(X))
    Yb = trsm_tiles_blocked_ref(torch.from_numpy(Lbad), torch.from_numpy(X))
    good = [t for t in range(nt) if t != bad]
    assert not torch.isfinite(Yb[bad]).any()
    assert torch.equal(Yb[good], Y[good])
    # the plain version the engines use on the CPU keeps the same contract
    Yr = trsm_tiles_batched_ref(torch.from_numpy(Lbad), torch.from_numpy(X))
    assert not torch.isfinite(Yr[bad]).all()
    assert torch.isfinite(Yr[good]).all()


def test_trsm_blocked_ref_rank_of_L(rng):
    # a shared (W, W) L is the per-slot solve with L repeated, bit for bit
    L, X = _blocked_inputs(rng, 4, 16, 32, True)
    Y = trsm_tiles_blocked_ref(torch.from_numpy(L), torch.from_numpy(X))
    Yb = trsm_tiles_blocked_ref(torch.from_numpy(np.repeat(L[None], 4, 0)),
                                torch.from_numpy(X))
    assert torch.equal(Y, Yb)


def _misaligned(*shape):
    """A contiguous f32 tensor of ones that starts 4 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.ones(n + 4)[1:n + 1].view(*shape)


@pytest.mark.parametrize("bad", ["dtype", "R12", "W136", "Lshape", "L3d",
                                 "noncontig", "device", "L_misaligned",
                                 "X_misaligned"])
def test_trsm_tiles_rejects(bad):
    nt, R, W = 2, 8, 16
    L, X = torch.eye(W), torch.ones(nt, R, W)
    if bad == "dtype":
        L = L.double()
    elif bad == "R12":
        X = torch.ones(nt, 12, W)
    elif bad == "W136":
        L, X = torch.eye(136), torch.ones(nt, R, 136)
    elif bad == "Lshape":
        L = torch.eye(W + 8)
    elif bad == "L3d":
        L = torch.eye(W).repeat(nt, 1, 1)
    elif bad == "noncontig":
        X = torch.ones(nt, W, R).mT
    elif bad == "L_misaligned":
        L = _misaligned(W, W)
    elif bad == "X_misaligned":
        X = _misaligned(nt, R, W)
    else:
        X = X.to("meta")
    with pytest.raises((TypeError, ValueError)):
        trsm_tiles(L, X)


def test_cpu_tensors_take_plain_version_and_count_nothing(rng):
    c0, t0 = chol_tiles.launches, trsm_tiles_batched.launches
    s0 = trsm_tiles.launches
    A = torch.from_numpy(_spd_tiles(rng, 2, 8))
    assert torch.equal(chol_tiles(A), chol_tiles_ref(A))
    L = torch.from_numpy(_lower(rng, 2, 16))
    X = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    assert torch.equal(trsm_tiles_batched(L, X),
                       trsm_tiles_batched_ref(L, X))
    assert torch.equal(trsm_tiles(L[0], X), trsm_tiles_ref(L[0], X))
    empty = chol_tiles(torch.zeros(0, 8, 8))
    assert empty.shape == (0, 8, 8)
    assert trsm_tiles(L[0], torch.zeros(0, 8, 16)).shape == (0, 8, 16)
    assert chol_tiles.launches == c0 == 0
    assert trsm_tiles_batched.launches == t0 == 0
    assert trsm_tiles.launches == s0 == 0


@pytest.mark.parametrize("bad", [
    "dtype", "width12", "width136", "noncontig"])
def test_chol_tiles_rejects(bad):
    A = {"dtype": torch.eye(8, dtype=torch.float64).expand(2, 8, 8),
         "width12": torch.eye(12).expand(2, 12, 12),
         "width136": torch.eye(136).expand(1, 136, 136),
         "noncontig": torch.eye(16)[None].expand(2, 16, 16)}[bad]
    if bad != "noncontig":
        A = A.contiguous()
    with pytest.raises((TypeError, ValueError)):
        chol_tiles(A)


@pytest.mark.parametrize("bad", ["dtype", "R12", "W12", "W136", "shape",
                                 "L_misaligned", "X_misaligned"])
def test_trsm_tiles_batched_rejects(bad):
    nt, R, W = 2, 8, 16
    L, X = torch.eye(W).repeat(nt, 1, 1), torch.ones(nt, R, W)
    if bad == "dtype":
        X = X.double()
    elif bad == "R12":
        X = torch.ones(nt, 12, W)
    elif bad == "W12":
        L, X = torch.eye(12).repeat(nt, 1, 1), torch.ones(nt, R, 12)
    elif bad == "W136":
        L, X = torch.eye(136).repeat(nt, 1, 1), torch.ones(nt, R, 136)
    elif bad == "L_misaligned":
        L = _misaligned(nt, W, W)
    elif bad == "X_misaligned":
        X = _misaligned(nt, R, W)
    else:
        L = torch.eye(W).repeat(nt + 1, 1, 1)
    with pytest.raises((TypeError, ValueError)):
        trsm_tiles_batched(L, X)


# ------------------------------------------------------- SpMV kernels
# The plain versions of the DIA, SELL and BELL kernels on buffers that
# the JAX package packed (through plan_from_numpy), against its Pallas
# kernels in interpret mode.  f32 sums in another order: 1e-5 of max|y|.
def _spmv_matrix(rng, n, offs=None):
    import scipy.sparse as sp
    from tpusparse.core import CSCMatrix
    if offs is not None:
        S = sp.diags([rng.normal(size=n - abs(o)) for o in offs], offs,
                     format="csc")
    else:
        S = sp.random(n, n, density=0.004, random_state=5, format="csc")
        S = (S + S.T + sp.eye(n) * 5).tocsc()
    S.sort_indices()
    return CSCMatrix(n, n, S.indptr, S.indices, S.data)


def test_dia_ref_matches_pallas_kernel(rng):
    from tpusparse.device.formats import to_dia as jax_to_dia
    from tpusparse.device.kernels.dia_spmv import dia_spmv_pallas
    from tpusparse_torch.device import plan_from_numpy
    A = _spmv_matrix(rng, 1500, [0, 1, -1, 30, -30, 700, -1100])
    D = jax_to_dia(A)
    x = rng.normal(size=A.n).astype(np.float32)
    yj = np.asarray(dia_spmv_pallas(jnp.asarray(D.bands), D.offsets,
                                    jnp.asarray(x), D.m, D.n))
    plan = plan_from_numpy(dict(m=D.m, n=D.n, mode="dia", offsets=D.offsets),
                           [D.bands], "cpu")
    assert _rel(plan.apply(x).numpy(), yj) <= 1e-5
    y = dia_spmv_ref(torch.from_numpy(D.bands),
                     torch.from_numpy(D.offsets.astype(np.int32)),
                     torch.from_numpy(x)).numpy()
    assert _rel(y, yj) <= 1e-5


@pytest.mark.parametrize("version", [1, 2])
def test_sell_ref_matches_pallas_kernel(rng, monkeypatch, version):
    from tpusparse.device.kernels.sell_spmv import build_sell_call
    from tpusparse.device.spmv import spmv_plan as jax_spmv_plan
    monkeypatch.setenv("TPUSPARSE_SELL_KERNEL", str(version))
    A = _spmv_matrix(rng, 5000)
    jp = jax_spmv_plan(A, mode="sell")
    assert jp.mode == "sell"
    bufs = [np.array(b) for b in jp._bufs]
    n = A.n
    ntiles = -(-n // 1024)
    x = rng.normal(size=n).astype(np.float32)
    xt = jnp.asarray(np.pad(x, (0, ntiles * 1024 - n)).reshape(ntiles, 8,
                                                               128))
    classes = [bufs[5 + 4 * c:9 + 4 * c] for c in range((len(bufs) - 5) // 4)]
    assert classes
    for bids, win, pos, vals in classes:
        NB, S = pos.shape[:2]
        call = build_sell_call(NB, S, ntiles, win.shape[1], version=version)
        out = np.asarray(call(jnp.asarray(win), jnp.asarray(pos),
                              jnp.asarray(vals), xt)).reshape(NB, 128)
        rows = bids[:, None].astype(np.int64) * 128 + np.arange(128)
        keep = rows < n
        # the padded slabs, and the compact pack made from them
        for ref, args in ((sell_slab_ref, (bids, win, pos, vals)),
                          (sell_spmv_ref, sell_pack(bids, win, pos, vals)),
                          (sell_spmv, sell_pack(bids, win, pos, vals))):
            y = torch.full((n,), float("nan"))
            ref(*(torch.from_numpy(a) for a in args), torch.from_numpy(x), y)
            assert _rel(y.numpy()[rows[keep]], out[keep]) <= 1e-5
            # rows of the other classes are left as they were
            assert np.isnan(np.delete(y.numpy(), rows[keep])).all()
    # the whole product of a port plan built from the JAX plan's buffers
    from tpusparse_torch.device import plan_from_numpy
    plan = plan_from_numpy(dict(m=n, n=n, mode="sell", perm=jp.perm), bufs,
                           "cpu")
    assert _rel(plan.apply(x).numpy(), np.asarray(jp.apply(x))) <= 1e-5


def test_bell_ref_matches_pallas_kernel(rng):
    import scipy.sparse as sp
    from tpusparse.core import CSCMatrix
    from tpusparse.device.formats import to_bell as jax_to_bell
    from tpusparse.device.spmv import _build_bell_fn
    P = sp.diags([np.ones(3), np.ones(2), np.ones(2)], [0, 1, -1])
    S = sp.kron(P, rng.normal(size=(128, 128)), format="csc")[:330, :350]
    S.sort_indices()
    A = CSCMatrix(330, 350, S.indptr, S.indices, S.data)
    B = jax_to_bell(A, bm=128, bk=128)
    x = rng.normal(size=A.n).astype(np.float32)
    yj = np.asarray(_build_bell_fn(B)(jnp.asarray(B.vals),
                                      jnp.asarray(B.tile_cols),
                                      jnp.asarray(x)))[:A.m]
    y = bell_spmv_ref(torch.from_numpy(B.vals),
                      torch.from_numpy(B.tile_cols), torch.from_numpy(x),
                      A.m).numpy()
    assert _rel(y, yj) <= 1e-5
    assert np.allclose(y, S @ x, rtol=0, atol=1e-5 * np.abs(yj).max())
    from tpusparse_torch.device import plan_from_numpy
    plan = plan_from_numpy(dict(m=A.m, n=A.n, mode="bell"),
                           [B.vals, B.tile_cols], "cpu")
    assert _rel(plan.apply(x).numpy(), yj) <= 1e-5


@pytest.mark.parametrize("bad", ["dtype", "offsets", "noncontig", "device"])
def test_dia_spmv_rejects(bad):
    bands, offs, x = torch.ones(2, 8), torch.tensor([0, 1],
                                                     dtype=torch.int32), \
        torch.ones(8)
    if bad == "dtype":
        x = x.double()
    elif bad == "offsets":
        offs = torch.tensor([0], dtype=torch.int32)
    elif bad == "noncontig":
        bands = torch.ones(8, 2).T
    else:
        x = x.to("meta")
    with pytest.raises((TypeError, ValueError)):
        dia_spmv(bands, offs, x)


@pytest.mark.parametrize("bad", ["S_shape", "win", "y", "dtype", "off",
                                 "rows", "cvals", "TW33"])
def test_sell_spmv_rejects(bad):
    NB, S, n = 2, 2, 256
    pack = sell_pack(np.arange(NB, dtype=np.int32),
                     np.zeros((NB, 1), np.int32),
                     np.zeros((NB, S, 8, 128), np.int32),
                     np.ones((NB, S, 8, 128), np.float32))
    args = dict(zip(("bids", "win", "off", "start", "rows", "cpos", "cvals"),
                    map(torch.from_numpy, pack)), x=torch.ones(n),
                y=torch.zeros(n))
    sell_spmv(**args)                           # the pack itself is taken
    assert torch.equal(args["y"], torch.full((n,), 16.0))
    if bad == "S_shape":
        args["start"] = args["start"][:, :-4].contiguous()
    elif bad == "win":
        args["win"] = torch.zeros(NB + 1, 1, dtype=torch.int32)
    elif bad == "y":
        args["y"] = torch.zeros(n - 1)
    elif bad == "dtype":
        args["cpos"] = args["cpos"].int()
    elif bad == "off":
        args["off"] = args["off"][:-1].contiguous()
    elif bad == "rows":
        args["rows"] = args["rows"].int()
    elif bad == "TW33":                         # a position needs 16 bits
        args["win"] = torch.zeros(NB, 33, dtype=torch.int32)
        with pytest.raises(ValueError):
            sell_pack(pack[0], np.zeros((NB, 33), np.int32),
                      np.zeros((NB, S, 8, 128), np.int32),
                      np.ones((NB, S, 8, 128), np.float32))
    else:
        args["cvals"] = args["cvals"][:-1].contiguous()
    with pytest.raises((TypeError, ValueError)):
        sell_spmv(**args)


@pytest.mark.parametrize("bad", ["tile", "cols", "m"])
def test_bell_spmv_rejects(bad):
    vals, cols, x, m = torch.zeros(2, 3, 128, 128), torch.zeros(
        2, 3, dtype=torch.int32), torch.ones(300), 256
    if bad == "tile":
        vals = torch.zeros(2, 3, 64, 128)
    elif bad == "cols":
        cols = torch.zeros(2, 2, dtype=torch.int32)
    else:
        m = 257
    with pytest.raises((TypeError, ValueError)):
        bell_spmv(vals, cols, x, m)


# ------------------------------------------------------------ LU tiles
def _swapped_tiles(rng, nt, W):
    """Diagonally dominant tiles with rows 0 and 1 and W/8 more disjoint
    pairs of adjacent rows (k, k + 1) swapped, where row k had no entry
    left of the diagonal and row k + 1 none left of its own: column k then
    meets an exact zero on the diagonal and the pair's other row below it,
    at every tol > 0.  The weak-diagonal shape that pivoting undoes, with
    the candidates of every column well apart."""
    M = (rng.normal(size=(nt, W, W))
         + 4 * np.sqrt(W) * np.eye(W)).astype(np.float32)
    for t in range(nt):
        for k in [0, *rng.choice(np.arange(2, W - 1, 2), size=max(1, W // 8),
                                 replace=False)]:
            M[t, k, :k] = 0.0
            M[t, k + 1, :k + 1] = 0.0
            M[t, [k, k + 1]] = M[t, [k + 1, k]]
    return M


def _eps(D):
    return float(np.float32(1e-8 * np.abs(D).max()))


def _lu_panel_jax(D, eps, tol):
    from tpusparse.device.superscan_lu import _lu_panel
    F, P = _lu_panel(jnp.asarray(D), jnp.float32(eps), tol)
    return np.asarray(F), np.asarray(P)


# P must be identical (no candidate is near another); F within 1e-5 of
# max|F|: both factorizations are backward stable on these inputs, and
# XLA rounds the rank-1 update in another order (a fused multiply-add)
@pytest.mark.parametrize("W", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("tol", [0.001, 1.0])
def test_lu_ref_matches_jax_lu_panel(rng, W, tol):
    inputs = [_swapped_tiles(rng, 3, W)]
    if tol == 1.0:                      # strict pivoting: any tile
        inputs.append(rng.normal(size=(3, W, W)).astype(np.float32))
    for D in inputs:
        eps = _eps(D)
        F, P = lu_tiles_ref(torch.from_numpy(D), eps, tol)
        Fj, Pj = _lu_panel_jax(D, eps, tol)
        assert np.array_equal(P.numpy(), Pj)
        assert _rel(F.numpy(), Fj) <= 1e-5
    assert (P.numpy() != np.eye(W)).any()       # pivoting took place
    L = np.tril(F.numpy(), -1) + np.eye(W)
    U = np.triu(F.numpy())
    assert np.abs(P.numpy() @ D - L @ U).max() <= 1e-5 * np.abs(D).max() * W


@pytest.mark.parametrize("W", [8, 16, 32, 64, 128])
def test_lu_ref_tol0_matches_jax_lu_nopiv(rng, W):
    from tpusparse.device.superscan_lu import _lu_nopiv
    D = (rng.normal(size=(3, W, W)) + W * np.eye(W)).astype(np.float32)
    eps = _eps(D)
    F, P = lu_tiles_ref(torch.from_numpy(D), eps, 0.0)
    Fj = np.asarray(_lu_nopiv(jnp.asarray(D), jnp.float32(eps)))
    assert np.array_equal(P.numpy(), np.broadcast_to(np.eye(W), P.shape))
    assert _rel(F.numpy(), Fj) <= 1e-5


@pytest.mark.parametrize("tol", [0.0, 0.001, 1.0])
def test_lu_ref_tiny_pivot_perturbed(tol):
    """A pivot below eps becomes +-eps with d's sign (+eps for -0.0), as
    in _lu_panel; the tile is otherwise untouched (identity around it)."""
    W = 8
    D = np.tile(np.eye(W, dtype=np.float32), (4, 1, 1))
    D[0, 2, 2] = 1e-12
    D[1, 2, 2] = -1e-12
    D[2, 2, 2] = 0.0
    D[3, 2, 2] = -0.0
    eps = 1e-6
    F, P = lu_tiles_ref(torch.from_numpy(D), eps, tol)
    Fj, Pj = _lu_panel_jax(D, eps, tol if tol else 1.0)
    assert F[:, 2, 2].tolist() == pytest.approx([eps, -eps, eps, eps])
    assert np.array_equal(F.numpy(), Fj) and np.array_equal(P.numpy(), Pj)


def test_lu_ref_nan_tile_leaves_the_others(rng):
    D = _swapped_tiles(rng, 5, 16)
    bad = D.copy()
    bad[2, 9, 3] = np.nan
    eps = _eps(D)
    F, P = lu_tiles_ref(torch.from_numpy(bad), eps, 1.0)
    G, Q = lu_tiles_ref(torch.from_numpy(D), eps, 1.0)
    good = [0, 1, 3, 4]
    assert not torch.isfinite(F[2]).all()
    assert torch.equal(F[good], G[good]) and torch.equal(P[good], Q[good])
    assert torch.equal(P.sum(1), torch.ones(5, 16))    # still one-hot
    assert torch.equal(P.sum(2), torch.ones(5, 16))


def test_lu_ref_tol0_keeps_the_diagonal_of_a_nan_tile(rng):
    """tol = 0 is _lu_nopiv: P = I, a NaN or inf in a column included."""
    from tpusparse.device.superscan_lu import _lu_nopiv
    W = 16
    D = (rng.normal(size=(4, W, W)) + W * np.eye(W)).astype(np.float32)
    eps = _eps(D)
    D[1, 9, 3] = np.nan
    D[2, 11, 5] = np.inf
    F, P = lu_tiles_ref(torch.from_numpy(D), eps, 0.0)
    Fj = np.asarray(_lu_nopiv(jnp.asarray(D), jnp.float32(eps)))
    assert np.array_equal(P.numpy(), np.broadcast_to(np.eye(W), P.shape))
    assert not (torch.isfinite(F[1]).all() or torch.isfinite(F[2]).all())
    assert not (np.isfinite(Fj[1]).all() or np.isfinite(Fj[2]).all())
    good = [0, 3]
    assert _rel(F.numpy()[good], Fj[good]) <= 1e-5


def test_lu_ref_prefers_first_of_equal_candidates():
    """Ties go to the lowest row, as jnp.argmax has it."""
    D = np.zeros((1, 8, 8), np.float32)
    D[0, :, 0] = [0.5, 1.0, -2.0, 2.0, -2.0, 0, 0, 0]
    D[0] += 3 * np.eye(8, dtype=np.float32) * (np.arange(8) > 0)
    F, P = lu_tiles_ref(torch.from_numpy(D), 1e-9, 1.0)
    Fj, Pj = _lu_panel_jax(D, 1e-9, 1.0)
    assert P[0, 0].argmax().item() == 2
    assert np.array_equal(P.numpy(), Pj)


def _tie_tiles(rng, nt, W, tol):
    """Tiles on which every step of the pivoted LU is exact in f32, or
    rounds the same with and without a fused multiply-add (each product
    has a power of two or +-1 for a factor), so that ties survive in both
    packages: the rows of an upper triangular T (power-of-two diagonal,
    entries 0, +-1, +-2, +-4 above it) in a random order, so that the
    earlier swaps move many rows; at columns k = 1, 5, 9, ... the rows for
    k and k + 1 are T[k] and +-T[k] + T[k + 1], two candidates of equal
    |value| at column k; at column kb = W - 3, which keeps its row, the
    diagonal is exactly f32(tol) times the one other candidate's |value|
    (a power of two), or equal to it at tol >= 1."""
    M = np.zeros((nt, W, W), np.float32)
    for t in range(nt):
        T = np.triu(rng.choice([0.0, 0.0, 1.0, -1.0, 2.0, -2.0, 4.0, -4.0],
                               size=(W, W)), 1)
        T += np.diag(2.0 ** rng.integers(0, 4, size=W))
        rows = T.copy()
        for k in range(1, W - 1, 4):
            rows[k + 1] = rng.choice([1.0, -1.0]) * T[k] + T[k + 1]
        kb = W - 3
        big = 2.0 ** rng.integers(0, 4)
        rows[kb, kb] = (np.float32(tol) * np.float32(big) if tol < 1.0
                        else big)
        rows[kb, kb + 1:] = 0.0
        rows[kb + 1] = T[kb + 1]
        rows[kb + 1, kb] = -big
        order = np.concatenate([rng.permutation(kb), [kb],
                                kb + 1 + rng.permutation(W - kb - 1)])
        M[t] = rows[order]
    return M


# the tie rule of the lazy swaps in csrc/lu_tile.cu, pinned to the
# reference: equal candidates (one in a row an earlier swap moved, one
# not), pivots that are moved rows, and |a[k][k]| exactly at tol * max;
# P identical, F within 1e-5 of max|F| as in test_lu_ref_matches_jax_lu_panel
@pytest.mark.parametrize("W", [8, 24, 32, 40, 128])
@pytest.mark.parametrize("tol", [0.001, 1.0])
def test_lu_ref_matches_jax_lu_panel_on_tie_tiles(rng, W, tol):
    D = _tie_tiles(rng, 3, W, tol)
    eps = _eps(D)
    F, P = lu_tiles_ref(torch.from_numpy(D), eps, tol)
    Fj, Pj = _lu_panel_jax(D, eps, tol)
    assert np.array_equal(P.numpy(), Pj)
    assert _rel(F.numpy(), Fj) <= 1e-5
    assert (P.numpy() != np.eye(W)).any()
    kb = W - 3                          # the diagonal at tol * max is kept
    assert (P.numpy()[:, kb, kb] == 1).all()


def _pools(rng, rows, pw):
    L = rng.normal(size=(rows, pw)).astype(np.float32)
    L[rows - pw:] = np.eye(pw, dtype=np.float32)     # the pad block
    return torch.from_numpy(L), torch.from_numpy(
        rng.normal(size=(rows, pw)).astype(np.float32))


def test_lu_tiles_pool_ref_is_lu_tiles_on_the_pool_rows(rng):
    """F and P of each tile in its pool rows, zero past column W, every
    other row untouched; padded slots share the identity pad block."""
    pw, W, rows = 32, 24, 200
    L, U = _pools(rng, rows, pw)
    L0, U0 = L.clone(), U.clone()
    dbase = torch.tensor([0, 60, 24, rows - pw, rows - pw])
    eps = 1e-7
    lu_tiles_pool(L, U, dbase, W, eps, 1.0)
    F, P = lu_tiles_ref(torch.stack([L0[b:b + W, :W] for b in dbase]), eps,
                        1.0)
    for t, b in enumerate(dbase.tolist()):
        assert torch.equal(L[b:b + W, :W], F[t])
        assert torch.equal(U[b:b + W, :W], P[t])
        assert not L[b:b + W, W:].any() and not U[b:b + W, W:].any()
    assert torch.equal(L[rows - pw:rows - pw + W, :W], torch.eye(W))
    hit = torch.zeros(rows, dtype=torch.bool)
    for b in dbase.tolist():
        hit[b:b + W] = True
    assert torch.equal(L[~hit], L0[~hit]) and torch.equal(U[~hit], U0[~hit])


def test_lu_tiles_pool_cpu_takes_plain_version_and_counts_nothing(rng):
    L, U = _pools(rng, 300, 128)
    L2, U2 = L.clone(), U.clone()
    n0 = lu_tiles.launches
    dbase = torch.tensor([0, 128])
    lu_tiles_pool(L, U, dbase, 64, 1e-7, 0.001)
    lu_tiles_pool_ref(L2, U2, dbase, 64, 1e-7, 0.001)
    assert torch.equal(L, L2) and torch.equal(U, U2)
    lu_tiles_pool(L, U, torch.zeros(0, dtype=torch.int64), 64, 1e-7, 1.0)
    assert lu_tiles.launches == n0 == 0


@pytest.mark.parametrize("bad", ["dtype", "dbase", "U", "W", "narrow",
                                 "noncontig", "device"])
def test_lu_tiles_pool_rejects(bad):
    L, U, dbase, W = torch.zeros(64, 32), torch.zeros(64, 32), \
        torch.tensor([0, 32]), 16
    if bad == "dtype":
        L = L.double()
    elif bad == "dbase":
        dbase = dbase.int()
    elif bad == "U":
        U = torch.zeros(64, 16)
    elif bad == "W":
        W = 12
    elif bad == "narrow":
        W = 40
    elif bad == "noncontig":
        L = torch.zeros(32, 64).T
    else:
        dbase = dbase.to("meta")
    with pytest.raises((TypeError, ValueError)):
        lu_tiles_pool(L, U, dbase, W, 1e-7, 1.0)


def test_lu_tiles_cpu_takes_plain_version_and_counts_nothing(rng):
    n0 = lu_tiles.launches
    D = torch.from_numpy(_swapped_tiles(rng, 2, 16))
    for a, b in zip(lu_tiles(D, 1e-7, 1.0), lu_tiles_ref(D, 1e-7, 1.0)):
        assert torch.equal(a, b)
    F, P = lu_tiles(torch.zeros(0, 8, 8), 1e-7, 1.0)
    assert F.shape == P.shape == (0, 8, 8)
    assert lu_tiles.launches == n0 == 0


@pytest.mark.parametrize("bad", ["dtype", "W12", "W136", "shape",
                                 "noncontig", "device", "misaligned"])
def test_lu_tiles_rejects(bad):
    D = {"dtype": torch.eye(8, dtype=torch.float64).expand(2, 8, 8),
         "W12": torch.eye(12).expand(2, 12, 12),
         "W136": torch.eye(136).expand(1, 136, 136),
         "shape": torch.zeros(2, 8, 16),
         "noncontig": torch.eye(16)[None].expand(2, 16, 16),
         "device": torch.eye(8).expand(2, 8, 8),
         "misaligned": _misaligned(2, 8, 8)}[bad]
    if bad != "noncontig":
        D = D.contiguous()
    if bad == "device":
        D = D.to("meta")
    with pytest.raises((TypeError, ValueError)):
        lu_tiles(D, 1e-7, 1.0)


# ------------------------------------------------------------ dense LU
def _blocked_lu_pair(M, bs=8):
    from tpusparse.device.dense import blocked_lu as jax_blocked_lu
    from tpusparse_torch.device.dense import blocked_lu
    LU, perm = blocked_lu(torch.from_numpy(M))
    LUj, permj = jax_blocked_lu(jnp.asarray(M), bs)
    return LU.numpy(), perm.numpy(), np.asarray(LUj), np.asarray(permj)


@pytest.mark.parametrize("N", [16, 24, 32, 128])
def test_blocked_lu_matches_jax(rng, N):
    """getrf against the reference's blocked LU: the same pivots (first
    largest candidate over the remaining rows), the factors within 1e-5
    of max|LU| (another blocking, another order of summation)."""
    M = rng.normal(size=(N, N)).astype(np.float32)
    LU, perm, LUj, permj = _blocked_lu_pair(M)
    assert np.array_equal(perm, permj)
    assert _rel(LU, LUj) <= 1e-5
    L, U = np.tril(LU, -1) + np.eye(N), np.triu(LU)
    assert np.abs(M[perm] - L @ U).max() <= 1e-5 * N


def test_blocked_lu_zero_column_matches_jax(rng):
    """A block with a zero column: both leave it unscaled with a zero on
    the diagonal, which TpuLU.factor flags."""
    N = 32
    M = rng.normal(size=(N, N)).astype(np.float32)
    M[:, 5] = 0.0
    LU, perm, LUj, permj = _blocked_lu_pair(M)
    assert np.array_equal(perm, permj)
    assert LU[5, 5] == 0 and LUj[5, 5] == 0
    assert _rel(LU, LUj) <= 1e-5


def test_lu_solve_matches_jax(rng):
    from tpusparse.device.dense import lu_solve as jax_lu_solve
    from tpusparse_torch.device.dense import lu_solve
    N = 64
    M = rng.normal(size=(N, N)).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    LU, perm, LUj, permj = _blocked_lu_pair(M)
    x = lu_solve(torch.from_numpy(LU), torch.from_numpy(perm),
                 torch.from_numpy(b)).numpy()
    xj = np.asarray(jax_lu_solve(jnp.asarray(LUj), jnp.asarray(permj),
                                 jnp.asarray(b)))
    assert np.abs(x - xj).max() <= 1e-4 * np.abs(xj).max()
    assert np.abs(M @ x - b).max() <= 1e-3 * np.abs(b).max()
