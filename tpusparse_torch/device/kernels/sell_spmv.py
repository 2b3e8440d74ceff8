"""SELL-128 windowed-gather SpMV over one S class of 128-row blocks: the
general-pattern path of the device SpMV plan (mode "sell").

Counterpart of tpusparse/device/kernels/sell_spmv.py (the Pallas
kernels ``_kernel``, v1, and ``_kernel_v2``), fused with the scatter of
the block sums to their rows that follows them in
tpusparse/device/spmv.py.  The planner's (NB, S, 8, 128) slabs pad every
block to a power-of-two number of 8-entry sub-steps; ``sell_pack`` turns
one class's slabs, once, into a compact pack that holds the real entries
only (see its docstring), and the kernel reads that.  Both slab layouts
(TPUSPARSE_SELL_KERNEL 1 and 2) pack the same way: the planner sets
pos = slot * 1024 + (col mod 1024) in both.  On a CUDA tensor
``sell_spmv`` launches the hand-written kernel of csrc/sell_spmv.cu and
adds one to ``sell_spmv.launches``; on a CPU tensor it runs the plain
version ``sell_spmv_ref`` and counts nothing.  ``sell_slab_ref`` is the
plain product over the padded slabs, which the tests hold the pack to.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ._args import expect, one_device

__all__ = ["TILE", "PACK", "sell_pack", "sell_spmv", "sell_spmv_ref",
           "sell_slab_ref"]

TILE = 1024         # x entries per window tile
PACK = 7            # arrays of one class's pack
MAX_TW = 32         # window tiles a block: a position fits 16 bits


def sell_pack(bids: np.ndarray, win: np.ndarray, pos: np.ndarray,
              vals: np.ndarray) -> tuple:
    """The compact pack of one S class's slabs (host arrays in, host
    arrays out): ``(bids, win, off, start, rows, cpos, cvals)``.

    A slab slot is a real entry where ``vals != 0`` (padding has vals 0;
    a stored zero adds nothing to the product either).  Within each
    128-row block the rows are sorted by entry count, longest first
    (stable); ``rows`` (NB, 128) u8 maps sorted position to lane.  A
    row's entries keep their slab (s, q) order.  At depth d the first
    ``cnt[d]`` sorted rows have an entry; those are stored side by side,
    depth after depth, from entry ``off[b]`` on: entry d of sorted row r
    lies at ``off[b] + start[b, d] + r``.  ``off`` (NB + 1,) i32,
    ``start`` (NB, D + 1) i16 with D = 8 S the running sums of ``cnt``,
    ``cpos`` i16 (a position is slot * 1024 + col mod 1024 with slot <
    TW <= 32) and ``cvals`` f32 (off[NB],)."""
    NB, S = pos.shape[:2]
    D = S * 8
    if D > 255 or win.shape[1] > MAX_TW:
        raise ValueError(f"sell_pack: S <= 31 and TW <= {MAX_TW} expected, "
                         f"got S={S}, TW={win.shape[1]}")
    V = np.ascontiguousarray(vals).reshape(NB, D, 128)
    P = np.ascontiguousarray(pos).reshape(NB, D, 128)
    real = V != 0
    lens = real.sum(1)                                   # (NB, 128)
    order = np.argsort(-lens, axis=1, kind="stable")     # sorted -> lane
    rank = np.empty_like(order)                          # lane -> sorted
    np.put_along_axis(rank, order,
                      np.broadcast_to(np.arange(128), (NB, 128)), axis=1)
    # cnt[b, d] = rows of block b longer than d
    hist = np.bincount(
        (np.arange(NB)[:, None] * (D + 1) + lens).reshape(-1),
        minlength=NB * (D + 1)).reshape(NB, D + 1)
    cnt = 128 - np.cumsum(hist, axis=1)[:, :D]
    start = np.zeros((NB, D + 1), np.int64)
    np.cumsum(cnt, axis=1, out=start[:, 1:])
    off = np.zeros(NB + 1, np.int64)
    np.cumsum(start[:, -1], out=off[1:])
    if off[-1] >= 2 ** 31:
        raise ValueError("sell_pack: more than 2^31 entries in a class")
    depth = np.cumsum(real, axis=1, dtype=np.int16) - 1  # entry's depth
    b, _, lane = np.nonzero(real)
    dest = off[b] + start[b, depth[real]] + rank[b, lane]
    cpos = np.empty(int(off[-1]), np.int16)
    cvals = np.empty(int(off[-1]), np.float32)
    cpos[dest] = P[real]
    cvals[dest] = V[real]
    return (np.asarray(bids, np.int32), np.asarray(win, np.int32),
            off.astype(np.int32), start.astype(np.int16),
            order.astype(np.uint8), cpos, cvals)


def _check(bids, win, off, start, rows, cpos, cvals, x, y) -> torch.device:
    fn = "sell_spmv"
    expect(fn, "bids", bids, torch.int32, 1)
    expect(fn, "win", win, torch.int32, 2)
    expect(fn, "off", off, torch.int32, 1)
    expect(fn, "start", start, torch.int16, 2)
    expect(fn, "rows", rows, torch.uint8, 2)
    expect(fn, "cpos", cpos, torch.int16, 1)
    expect(fn, "cvals", cvals, torch.float32, 1)
    expect(fn, "x", x, torch.float32, 1)
    expect(fn, "y", y, torch.float32, 1)
    NB = bids.shape[0]
    if (win.shape[0] != NB or not 1 <= win.shape[1] <= MAX_TW
            or off.shape[0] != NB + 1
            or start.shape[0] != NB or start.shape[1] % 8 != 1
            or tuple(rows.shape) != (NB, 128)):
        raise ValueError(f"sell_spmv: win (NB, TW <= {MAX_TW}), off (NB "
                         f"+ 1,), start "
                         f"(NB, 8 S + 1) and rows (NB, 128) expected for "
                         f"NB={NB}, got win {tuple(win.shape)}, off "
                         f"{tuple(off.shape)}, start {tuple(start.shape)}, "
                         f"rows {tuple(rows.shape)}")
    if cpos.shape != cvals.shape:
        raise ValueError(f"sell_spmv: cpos {tuple(cpos.shape)} and cvals "
                         f"{tuple(cvals.shape)} differ")
    if y.shape != x.shape:
        raise ValueError(f"sell_spmv: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} differ")
    return one_device(fn, bids, win, off, start, rows, cpos, cvals, x, y)


def sell_slab_ref(bids: torch.Tensor, win: torch.Tensor, pos: torch.Tensor,
                  vals: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """The product over the padded slabs, pos and vals (NB, S, 8, 128):
    gather x at every slab slot, multiply, sum each lane's slots, write
    the block sums to their rows of ``y``."""
    NB, S = pos.shape[:2]
    n = x.shape[0]
    p = pos.reshape(NB, -1).long()
    j = win.long().gather(1, p >> 10) * TILE + (p & (TILE - 1))
    xv = torch.where(j < n, x[j.clamp(max=max(n - 1, 0))], 0.0)
    out = (vals.reshape(NB, S * 8, 128) * xv.reshape(NB, S * 8, 128)).sum(1)
    rows = bids.long()[:, None] * 128 + torch.arange(128, device=x.device)
    keep = rows < n
    y[rows[keep]] = out[keep]
    return y


def sell_spmv_ref(bids: torch.Tensor, win: torch.Tensor, off: torch.Tensor,
                  start: torch.Tensor, rows: torch.Tensor,
                  cpos: torch.Tensor, cvals: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Plain version over the compact pack: each entry's block, depth and
    sorted row from ``off`` and ``start``, gather x, multiply, add up per
    sorted row, write the sums to their rows of ``y``."""
    NB, n, dev = bids.shape[0], x.shape[0], x.device
    D = start.shape[1] - 1
    st = start.long()
    cnt = (st[:, 1:] - st[:, :-1]).reshape(-1)
    bd = torch.repeat_interleave(torch.arange(NB * D, device=dev), cnt)
    b = bd // D                               # each entry's block
    r = (torch.arange(cpos.shape[0], device=dev) - off.long()[b]
         - st[:, :-1].reshape(-1)[bd])        # and its sorted row
    p = cpos.long()
    j = win.long()[b, p >> 10] * TILE + (p & (TILE - 1))
    xv = torch.where(j < n, x[j.clamp(max=max(n - 1, 0))], 0.0)
    out = torch.zeros(NB * 128, dtype=x.dtype, device=dev)
    out.index_add_(0, b * 128 + r, cvals * xv)
    row = bids.long()[:, None] * 128 + rows.long()
    keep = row < n
    y[row[keep]] = out.view(NB, 128)[keep]
    return y


def sell_spmv(bids: torch.Tensor, win: torch.Tensor, off: torch.Tensor,
              start: torch.Tensor, rows: torch.Tensor, cpos: torch.Tensor,
              cvals: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """For each block b < NB and sorted row r < 128 with row = bids[b] *
    128 + rows[b, r] < n: y[row] = sum over d with r < start[b, d + 1] -
    start[b, d] of cvals[e] * x[win[b, cpos[e] >> 10] * 1024 + (cpos[e] &
    1023)], e = off[b] + start[b, d] + r.  The arguments are one class's
    pack as ``sell_pack`` makes it; x and y (n,) f32.  Writes into ``y``
    (other rows untouched) and returns it."""
    dev = _check(bids, win, off, start, rows, cpos, cvals, x, y)
    if dev.type == "cpu":
        return sell_spmv_ref(bids, win, off, start, rows, cpos, cvals, x, y)
    NB = bids.shape[0]
    if NB == 0:
        return y
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.tpt_sell_spmv(
        bids.data_ptr(), win.data_ptr(), off.data_ptr(), start.data_ptr(),
        rows.data_ptr(), cpos.data_ptr(), cvals.data_ptr(), x.data_ptr(),
        y.data_ptr(), NB, start.shape[1] - 1, win.shape[1], x.shape[0],
        stream), "tpt_sell_spmv")
    sell_spmv.launches += 1
    return y


sell_spmv.launches = 0
