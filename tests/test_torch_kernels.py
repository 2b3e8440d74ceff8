"""The port's kernel wrappers on the CPU (chol tiles, trsm tiles with a
per-slot and a shared L; DIA, SELL and BELL SpMV): their plain versions
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
                                            sell_pack, sell_slab_ref,
                                            sell_spmv, sell_spmv_ref,
                                            trsm_tiles, trsm_tiles_batched,
                                            trsm_tiles_batched_ref,
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


@pytest.mark.parametrize("bad", ["dtype", "R12", "W136", "Lshape", "L3d",
                                 "noncontig", "device"])
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


@pytest.mark.parametrize("bad", ["dtype", "R12", "W12", "W136", "shape"])
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
