"""tpusparse_torch's device SpMV against the JAX package's, on the CPU.

Each test is the twin of one in tests/test_device_spmv.py: the same
matrix and x go through ``tpusparse.device.spmv_plan`` (Pallas in
interpret mode, as the JAX tests run it) and through
``tpusparse_torch.spmv_plan(..., device="cpu")`` (the kernels' plain
versions).  The two must choose the same mode, report exactly the same
plan fields, pack the same buffers bit for bit, and give y within
1e-5 * max|y_jax| (the sums run in another order, so y is not held bit
for bit).  Matrices are made with numpy and scipy and handed to each
package as its own CSCMatrix, built from the same arrays."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusparse.core import CSCMatrix, csc_from_dense, gaxpy
from tpusparse.device import gaxpy_device as jax_gaxpy_device
from tpusparse.device import spmv_plan as jax_spmv_plan
from tpusparse.device.formats import to_bell as jax_to_bell
import tpusparse_torch
from tpusparse_torch.core import CSCMatrix as TCSC
from tpusparse_torch.device import plan_from_numpy, plan_to_numpy
from tpusparse_torch.device.formats import to_bell
from tpusparse_torch.device.kernels import (bell_spmv, dia_spmv, sell_pack,
                                            sell_slab_ref, sell_spmv,
                                            sell_spmv_ref)
from helpers import random_csc, random_spd

TOL = 1e-5            # y, relative to max|y_jax|
FIELDS = ("m", "n", "mode", "flops", "bytes_min", "bytes_padded",
          "waste_ratio", "spill")


def _port(A):
    """The port's CSCMatrix from the arrays of the JAX package's."""
    return TCSC(A.m, A.n, A.indptr, A.indices, A.data)


def _np(y):
    return y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _same_plan(tp, jp):
    """Plan fields exactly, buffers bit for bit."""
    for f in FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    if jp.perm is None:
        assert tp.perm is None
    else:
        assert np.array_equal(tp.perm, jp.perm)
    _, bufs = plan_to_numpy(tp)
    assert len(bufs) == len(jp._bufs)
    for a, b in zip(bufs, jp._bufs):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _twin(A, mode, jax_env=(), monkeypatch=None):
    """(port plan, JAX plan) for A, checked equal.  ``jax_env`` is set
    for the JAX planner only."""
    if jax_env:
        with monkeypatch.context() as m:
            for k, v in jax_env:
                m.setenv(k, v)
            jp = jax_spmv_plan(A, mode=mode)
    else:
        jp = jax_spmv_plan(A, mode=mode)
    tp = tpusparse_torch.spmv_plan(_port(A), mode=mode, device="cpu")
    assert tp.mode == jp.mode
    _same_plan(tp, jp)
    return tp, jp


def _apply_twin(tp, jp, x):
    y = tp.apply(x)
    _close(y, jp.apply(x))
    return _np(y)


def _diags(diags, offs, shape=None):
    S = sp.diags(diags, offs, shape=shape, format="csc")
    S.sort_indices()
    return CSCMatrix(S.shape[0], S.shape[1], S.indptr, S.indices,
                     S.data), S


def test_ell_spmv_matches_host(rng):
    A, S = random_csc(rng, 50, 37, density=0.15)
    tp, jp = _twin(A, "ell")
    x = rng.normal(size=37)
    assert np.allclose(_apply_twin(tp, jp, x), S.toarray() @ x, atol=1e-5)


def test_bell_spmv_matches_host(rng):
    A, S = random_spd(rng, 40, density=0.4)
    tp, jp = _twin(A, "bell")
    x = rng.normal(size=40)
    assert np.allclose(_apply_twin(tp, jp, x), S.toarray() @ x, atol=1e-4)


def test_gaxpy_device(rng):
    A, S = random_csc(rng, 30, 30, density=0.2)
    x, y = rng.normal(size=30), rng.normal(size=30)
    got = tpusparse_torch.gaxpy_device(_port(A), x, y, device="cpu")
    assert isinstance(got, np.ndarray)
    _close(got, jax_gaxpy_device(A, x, y))
    assert np.allclose(got, gaxpy(A, x, y), atol=1e-5)


def test_plan_metrics(rng):
    A, S = random_csc(rng, 64, 64, density=0.1)
    tp, jp = _twin(A, "ell")
    assert tp.flops == 2 * A.nnz
    assert tp.bytes_min <= tp.bytes_padded


def test_auto_mode_picks_something(rng):
    A, S = random_csc(rng, 64, 64, density=0.1)
    tp, jp = _twin(A, "auto")
    assert tp.mode in ("ell", "bell", "sell")
    x = rng.normal(size=64)
    assert np.allclose(_apply_twin(tp, jp, x), S.toarray() @ x, atol=1e-4)


def test_dia_spmv_matches_host(rng):
    n = 100
    A, S = _diags([np.full(n, 4.0), -np.ones(n - 1), -np.ones(n - 1),
                   -np.ones(n - 7)], [0, 1, -1, 7])
    tp, jp = _twin(A, "dia")
    assert tp.mode == "dia"
    assert np.array_equal(tp.offsets, [-1, 0, 1, 7])
    x = rng.normal(size=n)
    assert np.allclose(_apply_twin(tp, jp, x), S.toarray() @ x, atol=1e-5)


def test_dia_rectangular(rng):
    A, S = _diags([np.ones(8), 2 * np.ones(8)], [0, 3], shape=(8, 11))
    tp, jp = _twin(A, "dia")
    x = rng.normal(size=11)
    assert np.allclose(_apply_twin(tp, jp, x), S.toarray() @ x, atol=1e-5)
    # and the other way round: more rows than columns
    A2, S2 = _diags([np.ones(8), 2 * np.ones(6)], [0, -5], shape=(11, 8))
    tp2, jp2 = _twin(A2, "dia")
    x2 = rng.normal(size=8)
    assert np.allclose(_apply_twin(tp2, jp2, x2), S2.toarray() @ x2,
                       atol=1e-5)


def test_auto_picks_dia_for_stencil(rng):
    n = 64
    A, S = _diags([np.full(n, 5.0), -np.ones(n - 1), -np.ones(n - 1),
                   -np.ones(n - 8), -np.ones(n - 8)], [0, 1, -1, 8, -8])
    tp, jp = _twin(A, "auto")
    assert tp.mode == "dia"


def test_spmm_apply_many(rng):
    A, S = random_csc(rng, 40, 33, density=0.2)
    X = rng.normal(size=(33, 6))
    tp, jp = _twin(A, "ell")
    Y = tp.apply_many(X)
    assert Y.shape == (40, 6)
    _close(Y, jp.apply_many(X))
    assert np.allclose(_np(Y), S.toarray() @ X, atol=1e-4)
    n = 32
    A2, S2 = _diags([np.full(n, 4.0), -np.ones(n - 1)], [0, 1])
    tp2, jp2 = _twin(A2, "dia")
    X2 = rng.normal(size=(n, 3))
    Y2 = tp2.apply_many(X2)
    _close(Y2, jp2.apply_many(X2))
    assert np.allclose(_np(Y2), S2.toarray() @ X2, atol=1e-5)
    _close(tp2.apply_many(X2[:, 0]), S2.toarray() @ X2[:, 0])


def test_dia_pallas_kernel(rng, monkeypatch):
    """The JAX side takes its Pallas DIA kernel (interpret mode); the
    port's DIA path is the same with or without the variable."""
    n = 700
    A, S = _diags([np.full(n, 6.0), -np.ones(n - 1), -np.ones(n - 1),
                   -np.ones(n - 25), -np.ones(n - 25)], [0, 1, -1, 25, -25])
    tp, jp = _twin(A, "dia", [("TPUSPARSE_PALLAS_DIA", "1")], monkeypatch)
    x = rng.normal(size=n)
    with monkeypatch.context() as m:
        m.setenv("TPUSPARSE_PALLAS_DIA", "1")
        yj = np.asarray(jp.apply(x))
    y = _np(tp.apply(x))
    _close(y, yj)
    assert np.allclose(y, S.toarray() @ x, atol=1e-4)


def _local_graph(rng, n=900):
    rows, cols = [], []
    for i in range(n):
        for d in rng.integers(1, 40, size=4):
            rows.append(i)
            cols.append((i + int(d)) % n)
    rows += [0, 1, 2]
    cols += [n - 1, n // 2, n - 3]
    v = rng.normal(size=len(rows))
    M = sp.coo_matrix((v, (rows, cols)), shape=(n, n)).tocsc()
    M = (M + M.T + sp.eye(n) * 8).tocsc()
    M.sort_indices()
    return CSCMatrix(n, n, M.indptr, M.indices, M.data)


def test_sell_windowed_gather(rng):
    A = _local_graph(rng)
    n = A.n
    tp, jp = _twin(A, "sell")
    assert tp.mode == "sell"
    x = rng.normal(size=n)
    y = _apply_twin(tp, jp, x)
    yref = gaxpy(A, x, np.zeros(n))
    assert np.abs(y - yref).max() / np.abs(yref).max() < 1e-5
    y2 = tp.gaxpy(x, np.ones(n))
    _close(y2, jp.gaxpy(x, np.ones(n)))
    assert np.allclose(_np(y2), yref + 1.0, atol=1e-4)


def _random_sym(n, density, seed, diag):
    M = sp.random(n, n, density=density, random_state=seed, format="csc")
    M = (M + M.T + sp.eye(n) * diag).tocsc()
    M.sort_indices()
    return CSCMatrix(n, n, M.indptr, M.indices, M.data), M


def test_sell_kernel_versions_match(rng, monkeypatch):
    """Both slab layouts (TPUSPARSE_SELL_KERNEL 1 and 2) plan the same
    buffers in both packages, and the port's one kernel computes the
    same product on both."""
    A, M = _random_sym(3000, 0.002, 7, 5)
    x = rng.normal(size=A.n).astype(np.float32)
    yref = M @ x
    ys = {}
    for ver in ("1", "2"):
        monkeypatch.setenv("TPUSPARSE_SELL_KERNEL", ver)
        tp, jp = _twin(A, "sell")
        assert tp.mode == "sell"
        ys[ver] = _apply_twin(tp, jp, x)
        assert np.abs(ys[ver] - yref).max() / np.abs(yref).max() < 1e-5
    assert np.allclose(ys["1"], ys["2"], rtol=1e-5, atol=1e-6)


def test_sell_apply_permuted(rng):
    A, M = _random_sym(2000, 0.003, 3, 5)
    n = A.n
    tp, jp = _twin(A, "sell")
    x = rng.normal(size=n).astype(np.float32)
    y = _apply_twin(tp, jp, x)
    p = tp.perm
    yp = tp.apply_permuted(x[p])
    _close(yp, jp.apply_permuted(x[p]))
    y2 = np.empty(n, np.float32)
    y2[p] = _np(yp)
    assert np.allclose(y, y2, rtol=1e-5, atol=1e-6)
    dia = tpusparse_torch.spmv_plan(_port(A), mode="dia", device="cpu")
    with pytest.raises(ValueError):
        dia.apply_permuted(x)


def test_sell_identity_first_ordering(rng):
    n = 16384
    diags = [rng.normal(size=n - abs(k)) for k in range(-12, 13)]
    M = sp.diags(diags, list(range(-12, 13)), format="csc")
    M = (M + M.T + sp.eye(n) * 30).tocsc()
    M.sort_indices()
    A = CSCMatrix(n, n, M.indptr, M.indices, M.data)
    tp, jp = _twin(A, "sell")
    assert np.array_equal(tp.perm, np.arange(n))
    x = rng.normal(size=n).astype(np.float32)
    y = _apply_twin(tp, jp, x)
    yref = gaxpy(A, x, np.zeros(n))
    assert np.abs(y - yref).max() / np.abs(yref).max() < 1e-5

    q = rng.permutation(n)
    Ms = M[q][:, q].tocsc()
    Ms.sort_indices()
    As = CSCMatrix(n, n, Ms.indptr, Ms.indices, Ms.data)
    tps, jps = _twin(As, "sell")
    assert not np.array_equal(tps.perm, np.arange(n))
    ys = _apply_twin(tps, jps, x)
    ysref = gaxpy(As, x, np.zeros(n))
    assert np.abs(ys - ysref).max() / np.abs(ysref).max() < 1e-5


# ------------------------------------------------------- compact pack
def _odd_blocks(rng):
    """n = 640: block 0 has rows of one length (3 entries), block 1 is
    empty, block 2 mixes lengths 0..12 and stores explicit zeros, blocks
    3 and 4 are a random pattern."""
    n = 640
    r, c, v = [], [], []
    for i in range(128):
        for d in (0, 1, 2):
            r.append(i), c.append((i + d) % 128), v.append(rng.normal())
    for i in range(256, 384):
        for d in range((i * 7) % 13):
            r.append(i), c.append(256 + (i + 5 * d) % 128)
            v.append(0.0 if d == 2 else rng.normal())
    R = sp.random(256, 256, density=0.03, random_state=11, format="coo")
    r += list(R.row + 384)
    c += list(R.col + 384)
    v += list(R.data + 1.0)
    order = np.lexsort((r, c))
    r, c, v = (np.asarray(a)[order] for a in (r, c, v))
    indptr = np.searchsorted(c, np.arange(n + 1))
    return CSCMatrix(n, n, indptr, r, v.astype(np.float64))


_PACK_FIXTURES = {
    "local": lambda rng: _local_graph(rng),
    "random": lambda rng: _random_sym(3000, 0.002, 7, 5)[0],
    "odd_blocks": _odd_blocks,
}


@pytest.mark.parametrize("version", ["1", "2"])
@pytest.mark.parametrize("fixture", sorted(_PACK_FIXTURES))
def test_sell_compact_pack(rng, monkeypatch, fixture, version):
    """The compact pack of the JAX-equal slabs, class by class: its plain
    version gives what the plain product over the padded slabs gives;
    the whole plan gives what the JAX plan (its Pallas kernel in
    interpret mode) and scipy give; and the host buffers come back bit
    for bit from a round trip through plan_from_numpy."""
    monkeypatch.setenv("TPUSPARSE_SELL_KERNEL", version)
    A = _PACK_FIXTURES[fixture](rng)
    n = A.n
    tp, jp = _twin(A, "sell")
    assert tp.mode == "sell"
    x = rng.normal(size=n).astype(np.float32)
    xt = torch.from_numpy(x)
    bufs = [np.asarray(b) for b in jp._bufs]
    assert (len(bufs) - 5) % 4 == 0 and len(tp._bufs) == 5 + 7 * (
        (len(bufs) - 5) // 4)
    for ci in range((len(bufs) - 5) // 4):
        slabs = bufs[5 + 4 * ci:9 + 4 * ci]
        pack = sell_pack(*slabs)
        for a, t in zip(pack, tp._bufs[5 + 7 * ci:12 + 7 * ci]):
            assert a.dtype == t.numpy().dtype and np.array_equal(a, t.numpy())
        ys = torch.full((n,), float("nan"))
        yc = torch.full((n,), float("nan"))
        sell_slab_ref(*map(torch.from_numpy, slabs), xt, ys)
        sell_spmv_ref(*map(torch.from_numpy, pack), xt, yc)
        assert np.array_equal(np.isnan(ys.numpy()), np.isnan(yc.numpy()))
        rows = ~np.isnan(ys.numpy())
        assert rows.sum() == min(n, slabs[0].max() * 128 + 128) - (
            slabs[0].max() * 128) + (slabs[0].size - 1) * 128
        _close(yc.numpy()[rows], ys.numpy()[rows])
        # every real slab entry is in the pack, and nothing else
        real = slabs[3] != 0
        assert pack[5].size == real.sum() == pack[2][-1]
        assert np.array_equal(np.sort(pack[6]), np.sort(slabs[3][real]))
    yref = A.toscipy() @ x.astype(np.float64)
    y = _apply_twin(tp, jp, x)
    assert np.abs(y - yref).max() <= TOL * np.abs(yref).max()
    p = tp.perm
    _close(tp.apply_permuted(x[p]), yref[p])
    _close(tp.gaxpy(x, np.ones(n)), yref + 1.0)
    tq = plan_from_numpy(*plan_to_numpy(tp), "cpu")
    _same_plan(tq, jp)
    assert np.array_equal(_np(tq.apply(x)), y)


def test_sell_pack_layout():
    """One block by hand: rows sorted by length (stable, longest first),
    a row's entries in slab order, depth after depth."""
    pos = np.zeros((1, 1, 8, 128), np.int32)
    vals = np.zeros((1, 1, 8, 128), np.float32)
    # lane 3: two entries, lane 7: three, lane 9: two, lane 100: one
    for lane, k in ((3, 2), (7, 3), (9, 2), (100, 1)):
        for q in range(k):
            pos[0, 0, q, lane] = 10 * lane + q
            vals[0, 0, q, lane] = lane + q / 10
    bids, win, off, start, rows, cpos, cvals = sell_pack(
        np.array([4], np.int32), np.zeros((1, 2), np.int32), pos, vals)
    assert (off.dtype, start.dtype, rows.dtype, cpos.dtype, cvals.dtype) == (
        np.int32, np.int16, np.uint8, np.int16, np.float32)
    assert off.tolist() == [0, 8]
    assert start[0].tolist() == [0, 4, 7, 8, 8, 8, 8, 8, 8]
    assert rows[0, :5].tolist() == [7, 3, 9, 100, 0]
    assert cpos.tolist() == [70, 30, 90, 1000, 71, 31, 91, 72]
    assert np.allclose(cvals, [7, 3, 9, 100, 7.1, 3.1, 9.1, 7.2])
    x = np.arange(2048, dtype=np.float32)
    y = torch.zeros(2048)
    sell_spmv(*map(torch.from_numpy, (bids, win, off, start, rows, cpos,
                                      cvals)), torch.from_numpy(x), y)
    want = np.zeros(2048)
    want[512 + 7] = 7 * 70 + 7.1 * 71 + 7.2 * 72
    want[512 + 3] = 3 * 30 + 3.1 * 31
    want[512 + 9] = 9 * 90 + 9.1 * 91
    want[512 + 100] = 100 * 1000
    assert np.allclose(y.numpy(), want, rtol=1e-6)


def test_sell_pack_bytes(rng):
    """At about 9 entries a row the pack holds at most 1.15 times the
    bytes the product needs (entries at 4 + 2 bytes, bids, win, the x
    entries read and the y rows written, once each); the padded slabs
    hold far more."""
    A = _local_graph(rng, 4000)
    assert 8 <= A.nnz / A.n <= 10
    tp = tpusparse_torch.spmv_plan(_port(A), mode="sell", device="cpu")
    _, bufs = plan_to_numpy(tp)
    flat = [t.numpy() for t in tp._bufs[5:]]
    need = read = slab = 0
    for ci in range(len(flat) // 7):
        bids, win, off, start, rows, cpos, cvals = flat[7 * ci:7 * ci + 7]
        blk = np.repeat(np.arange(bids.size), np.diff(off))
        j = win[blk, cpos >> 10].astype(np.int64) * 1024 + (cpos & 1023)
        ny = (bids[:, None].astype(np.int64) * 128 + rows < A.n).sum()
        need += cpos.size * 6 + (bids.size + win.size + np.unique(j).size
                                 + ny) * 4
        read += sum(a.nbytes for a in flat[7 * ci:7 * ci + 7]) + (
            np.unique(j).size + ny) * 4
        slab += bufs[7 + 4 * ci].nbytes + bufs[8 + 4 * ci].nbytes
    assert need < read <= 1.15 * need
    assert slab > 1.5 * need


# ------------------------------------------------------- seg (power-law)
def _ba_graph(n, m0=4, seed=0):
    """Barabasi-Albert preferential attachment (power-law degrees), as
    tests/test_device_spmv.py builds it."""
    rng = np.random.default_rng(seed)
    repeated = list(range(m0))
    rows, cols = [], []
    for v in range(m0, n):
        tg = (list(range(m0)) if v == m0
              else rng.choice(repeated, size=m0))
        for t in tg:
            rows.append(v)
            cols.append(int(t))
            repeated.append(int(t))
            repeated.append(v)
    S = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    S = (S + S.T + sp.eye(n)).tocsc()
    S.sort_indices()
    return CSCMatrix(n, n, S.indptr, S.indices, S.data), S


_BA = {}


def _ba(n, seed=0):
    """One graph per (n, seed) for the whole module (it costs seconds)."""
    if (n, seed) not in _BA:
        _BA[n, seed] = _ba_graph(n, seed=seed)
    return _BA[n, seed]


def test_seg_spmv_power_law(rng):
    A, S = _ba(3000)
    tp, jp = _twin(A, "auto")
    assert tp.mode == "seg"
    assert tp.spill == 0
    assert tp.waste_ratio < 0.5
    x = rng.normal(size=A.n)
    assert np.allclose(_apply_twin(tp, jp, x), S @ x, atol=1e-4, rtol=1e-4)


def test_seg_vs_sell_on_heavy_tail(rng):
    A, S = _ba(3000)
    seg, _ = _twin(A, "seg")
    sell, jsell = _twin(A, "sell")
    assert sell.mode == "sell"
    assert sell.spill / A.nnz > 0.05
    assert seg.spill == 0
    assert seg.bytes_padded <= 2 * (A.nnz * 8 + (A.m + A.n) * 4)
    x = rng.normal(size=A.n)
    assert np.allclose(_apply_twin(sell, jsell, x), S @ x, atol=1e-4,
                       rtol=1e-4)


def test_seg_mode_not_selected_for_uniform(rng):
    A, S = random_spd(rng, 200, density=0.05)
    tp, jp = _twin(A, "auto")
    assert tp.mode != "seg"


def test_seg_gaxpy_and_many(rng):
    A, S = _ba(1000, seed=2)
    tp, jp = _twin(A, "seg")
    X = rng.normal(size=(A.n, 3))
    Y = tp.apply_many(X)
    _close(Y, jp.apply_many(X))
    assert np.allclose(_np(Y), S @ X, atol=1e-4, rtol=1e-4)
    y0 = rng.normal(size=A.n)
    _close(tp.gaxpy(X[:, 0], y0), jp.gaxpy(X[:, 0], y0))


def test_sell_sort_permute_matches_gather(rng, monkeypatch):
    """The port has no sort transport: it always gathers.  Its result
    is held to the JAX package's gather-mode result on the same plan."""
    n = 256
    d = (rng.random((n, n)) < 0.03) * rng.normal(size=(n, n))
    d = d + d.T + np.eye(n) * 10
    A = csc_from_dense(d)
    x = rng.normal(size=n)
    tp, jp = _twin(A, "sell", [("TPUSPARSE_SELL_PERMUTE", "gather")],
                   monkeypatch)
    with monkeypatch.context() as m:
        m.setenv("TPUSPARSE_SELL_PERMUTE", "gather")
        yj = np.asarray(jp.apply(x))
    y = _np(tp.apply(x))
    _close(y, yj)
    assert np.allclose(y, d @ x, atol=1e-3)
    # the variable does not change the port's plan or result
    monkeypatch.setenv("TPUSPARSE_SELL_PERMUTE", "sort")
    tps = tpusparse_torch.spmv_plan(_port(A), mode="sell", device="cpu")
    assert np.array_equal(_np(tps.apply(x)), y)


# ------------------------------------------------------- port-only
@pytest.mark.parametrize("m,n,bm,bk", [(300, 500, 128, 128),
                                       (257, 129, 8, 16), (50, 37, 8, 128)])
def test_to_bell_matches_jax_with_duplicates(rng, m, n, bm, bk):
    """The vectorised to_bell against the JAX package's loop, bit for
    bit, on a matrix whose columns hold duplicate entries (summed in
    storage order) at values of mixed magnitudes."""
    cols = rng.integers(0, n, 2500)
    rows = rng.integers(0, m, 2500)
    dup = rng.integers(0, 2500, 500)               # 500 repeated entries
    cols = np.concatenate([cols, cols[dup]])
    rows = np.concatenate([rows, rows[dup]])
    order = np.argsort(cols, kind="stable")
    rows, cols = rows[order], cols[order]
    indptr = np.searchsorted(cols, np.arange(n + 1))
    data = rng.normal(size=cols.size) * 10.0 ** rng.integers(-6, 6,
                                                             cols.size)
    a = jax_to_bell(CSCMatrix(m, n, indptr, rows, data), bm, bk)
    b = to_bell(TCSC(m, n, indptr, rows, data), bm, bk)
    assert (a.K, a.m, a.n, a.nnz) == (b.K, b.m, b.n, b.nnz)
    assert a.vals.dtype == b.vals.dtype and a.tile_cols.dtype == \
        b.tile_cols.dtype
    assert np.array_equal(a.vals.view(np.int32), b.vals.view(np.int32))
    assert np.array_equal(a.tile_cols, b.tile_cols)


def test_plan_round_trip(rng):
    """plan_to_numpy -> plan_from_numpy rebuilds an equal plan."""
    A = _local_graph(rng, 600)
    tp = tpusparse_torch.spmv_plan(_port(A), mode="sell", device="cpu")
    meta, bufs = plan_to_numpy(tp)
    tq = plan_from_numpy(meta, bufs, "cpu")
    x = rng.normal(size=A.n)
    assert np.array_equal(_np(tq.apply(x)), _np(tp.apply(x)))
    with pytest.raises(ValueError):
        plan_from_numpy(dict(meta, mode="coo"), bufs, "cpu")


def test_cpu_plans_count_no_launches(rng):
    c = (dia_spmv.launches, sell_spmv.launches, bell_spmv.launches)
    A = _local_graph(rng, 300)
    for mode in ("dia", "sell", "bell"):
        tpusparse_torch.spmv_plan(_port(A), mode=mode,
                                  device="cpu").apply(np.ones(A.n))
    assert (dia_spmv.launches, sell_spmv.launches,
            bell_spmv.launches) == c == (0, 0, 0)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        tpusparse_torch.spmv_plan(TCSC(2, 2, [0, 1, 2], [0, 1], [1., 1.]))
