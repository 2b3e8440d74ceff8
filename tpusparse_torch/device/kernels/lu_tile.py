"""Batched LU with threshold partial pivoting inside each (W, W) tile: the
panel-LU phase of the superscan LU factorization.

Computes what ``_lu_panel`` of tpusparse/device/superscan_lu.py (:104)
computes; the JAX package has no Pallas kernel for it (XLA fuses the
column loop), and its ``tol == 0`` path (``_lu_nopiv``, :68) is the same
function summed in another order.  On a CUDA tensor ``lu_tiles`` launches
the hand-written kernel of csrc/lu_tile.cu and adds one to
``lu_tiles.launches``; on a CPU tensor it returns the plain version
``lu_tiles_ref`` and counts nothing.

Contract, per tile D: (F, P) with F = L\\U packed (L's unit diagonal
implied) and P one-hot, P[i, perm[i]] = 1, so that P @ D = L @ U.  At
column k the pivot row is the first row r >= k with the largest |D[r, k]|,
unless |D[k, k]| >= tol * that largest value (``tol`` = 0 keeps every
diagonal, a non-finite column's too: P = I).  A pivot with |d| < eps becomes -eps where d < 0, else
+eps; a NaN stays NaN, and a tile with a NaN comes out non-finite.

``lu_tiles_pool`` is the same function on tiles that lie in a pool of
rows (SuperscanLU's panel phase): it factors them in place and writes P
into the U pool, one launch and no gather or scatter around it; it counts
under ``lu_tiles.launches``, and ``lu_tiles_pool_ref`` is its plain
version.
"""

from __future__ import annotations

import torch
from torch.nn.functional import pad

from . import _build
from ._args import expect, one_device

__all__ = ["lu_tiles", "lu_tiles_ref", "lu_tiles_pool", "lu_tiles_pool_ref"]

_MAX_W = 128


def _check_w(fn: str, W: int) -> None:
    if W % 8 or not 8 <= W <= _MAX_W:
        raise ValueError(f"{fn}: W must be a multiple of 8 in "
                         f"[8, {_MAX_W}], got {W}")


def _check(D: torch.Tensor) -> torch.device:
    expect("lu_tiles", "D", D, torch.float32, 3)
    if D.shape[1] != D.shape[2]:
        raise ValueError(f"lu_tiles: (nt, W, W) expected, got "
                         f"{tuple(D.shape)}")
    _check_w("lu_tiles", D.shape[1])
    if D.data_ptr() % 16:           # the kernel reads 16 bytes at a time
        raise ValueError("lu_tiles: D must be 16-byte aligned")
    return one_device("lu_tiles", D)


def lu_tiles_ref(D: torch.Tensor, eps: float, tol: float) -> tuple:
    """Plain version: ``_lu_panel``'s column loop in torch ops (about 20 a
    column).  The division and the rank-1 update round as the kernel's
    do, so on the card the two agree bit for bit on finite input."""
    nt, W, _ = D.shape
    D = D.clone()
    r = torch.arange(W, device=D.device)
    ar = torch.arange(nt, device=D.device)
    perm = r.expand(nt, W).clone()
    zero = torch.zeros((), dtype=D.dtype, device=D.device)
    for k in range(W):
        colm = torch.where(r >= k, D[:, :, k].abs(), -1.0)
        j = torch.argmax(colm, dim=1)
        maxv = torch.amax(colm, dim=1)
        j = torch.where((D[:, k, k].abs() >= tol * maxv) | (tol == 0.0), k, j)
        rk, rj = D[ar, k].clone(), D[ar, j].clone()
        D[ar, j] = rk
        D[ar, k] = rj
        pk, pj = perm[:, k].clone(), perm[ar, j].clone()
        perm[ar, j] = pk
        perm[:, k] = pj
        d = D[:, k, k]
        d = torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)
        D[:, k, k] = d
        lcol = torch.where(r > k, D[:, :, k] / d[:, None], zero)
        D[:, :, k] = torch.where(r > k, lcol, D[:, :, k])
        urow = torch.where(r > k, D[:, k, :], zero)
        D = D - lcol[:, :, None] * urow[:, None, :]
    return D, (perm[:, :, None] == r).to(D.dtype)


def lu_tiles(D: torch.Tensor, eps: float, tol: float) -> tuple:
    """(F, P) of the (nt, W, W) f32 tiles D, W a multiple of 8 in
    [8, 128]; ``eps`` and ``tol`` are taken as f32."""
    dev = _check(D)
    if dev.type == "cpu":
        return lu_tiles_ref(D, eps, tol)
    F, P = torch.empty_like(D), torch.empty_like(D)
    nt, W, _ = D.shape
    if nt == 0:
        return F, P
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.tpt_lu_tiles(D.data_ptr(), F.data_ptr(), P.data_ptr(),
                                  nt, W, eps, tol, stream), "tpt_lu_tiles")
    lu_tiles.launches += 1
    return F, P


lu_tiles.launches = 0


def _check_pool(L: torch.Tensor, U: torch.Tensor, dbase: torch.Tensor,
                W: int) -> torch.device:
    fn = "lu_tiles_pool"
    expect(fn, "L", L, torch.float32, 2)
    expect(fn, "U", U, torch.float32, 2)
    expect(fn, "dbase", dbase, torch.int64, 1)
    if U.shape != L.shape:
        raise ValueError(f"{fn}: L {tuple(L.shape)} and U {tuple(U.shape)}")
    _check_w(fn, W)
    if L.shape[1] < W or L.shape[1] % 4:
        raise ValueError(f"{fn}: a pool row of {L.shape[1]} floats for "
                         f"W={W} (at least W, a multiple of 4)")
    if L.data_ptr() % 16 or U.data_ptr() % 16:
        raise ValueError(f"{fn}: the pools must be 16-byte aligned")
    return one_device(fn, L, U, dbase)


def lu_tiles_pool_ref(L: torch.Tensor, U: torch.Tensor, dbase: torch.Tensor,
                      W: int, eps: float, tol: float,
                      lu=lu_tiles_ref) -> None:
    """Plain version of ``lu_tiles_pool``: the tiles gathered, factored by
    ``lu`` (``lu_tiles_ref``; ``lu_tiles`` gives the gather path around
    the batched kernel), and F and P written back as whole pool rows,
    zero past column W.  Every tile is read before any is written, so
    slots that share a tile write the same rows alike."""
    pw = L.shape[1]
    idx = dbase[:, None] + torch.arange(W, device=L.device)
    Fk, Pk = lu(L[:, :W][idx].contiguous(), eps, tol)
    rows = idx.reshape(-1)
    L.index_copy_(0, rows, pad(Fk, (0, pw - W)).reshape(-1, pw))
    U.index_copy_(0, rows, pad(Pk, (0, pw - W)).reshape(-1, pw))


def lu_tiles_pool(L: torch.Tensor, U: torch.Tensor, dbase: torch.Tensor,
                  W: int, eps: float, tol: float) -> None:
    """In place, for each t: the (W, W) tile at rows dbase[t] .. dbase[t]
    + W - 1, columns 0 .. W - 1 of the (rows, pw) f32 pool L becomes its
    F, and the same rows of U its P, both rows zero past column W.  Slots
    that share a tile (the plan's padded slots on its pad block) must
    stand next to each other in dbase; the kernel stores the first of
    them only, so the shared tile becomes its LU once, as in the plain
    version, whatever it holds.  Tiles of different rows must not
    overlap."""
    dev = _check_pool(L, U, dbase, W)
    if dev.type == "cpu":
        lu_tiles_pool_ref(L, U, dbase, W, eps, tol)
        return
    nt = dbase.shape[0]
    if nt == 0:
        return
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.tpt_lu_tiles_pool(L.data_ptr(), U.data_ptr(),
                                       dbase.data_ptr(), nt, W, L.shape[1],
                                       eps, tol, stream),
                 "tpt_lu_tiles_pool")
    lu_tiles.launches += 1
