"""Device SpMV / gaxpy on a torch device (reference: csparse::cs_gaxpy;
counterpart of tpusparse/device/spmv.py).

The host planning is the JAX package's, copied: for the same matrix and
environment both packages choose the same mode, report the same plan
fields and pack the same buffers, bit for bit (tests/test_torch_spmv.py
holds them to each other).  The modes and what runs on the device:

- ``dia``: banded, gather-free; the DIA kernel (kernels.dia_spmv).
- ``sell``: general irregular pattern; identity or RCM ordering, SELL-128
  slabs per S class.  The slabs stay on the host (plan_to_numpy returns
  them); at upload each class is packed once into the compact form that
  holds only its real entries (kernels.sell_pack), and the SELL kernel
  (kernels.sell_spmv) reads that and writes its block sums straight to
  y; then the out-of-window COO spill as ``index_add_`` and, under RCM,
  the two permutations as gathers.
- ``bell``: block-structured; 128 x 128 dense tiles through the BELL
  kernel (kernels.bell_spmv).
- ``seg``: power-law row degrees; row-split ELL classes as torch
  gathers + ``index_add_`` (no kernel, as in the JAX package).
- ``ell``: scalar ELL gather + fma in torch (no kernel, as in the JAX
  package).

The kernel wrappers dispatch on the device of the plan's buffers: on a
CUDA tensor they launch the hand-written kernels, on a CPU tensor they
take their plain versions.

Left out: TPUSPARSE_SELL_PERMUTE's sort transport (the port always
gathers, as the JAX package does on the CPU), TPUSPARSE_PALLAS_DIA and
its VMEM limit (a CUDA plan always launches the DIA kernel).  Kept, and
read as the JAX package reads them: TPUSPARSE_SELL_KERNEL (slab layout
1, the default, or 2) and TPUSPARSE_SELL_ID_SPILL_MAX.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.matrix import CSCMatrix
from .config import DTYPE, round_up
from .formats import dia_offsets, to_bell, to_dia, to_ell
from .kernels import bell_spmv, dia_spmv, sell_pack, sell_spmv
from .kernels.sell_spmv import PACK, TILE

__all__ = ["SpmvPlan", "spmv_plan", "gaxpy_device", "plan_to_numpy",
           "plan_from_numpy"]

# plan fields carried by plan_to_numpy / plan_from_numpy
_FIELDS = ("m", "n", "mode", "flops", "bytes_min", "bytes_padded",
           "waste_ratio", "spill", "perm", "offsets")


@dataclass
class SpmvPlan:
    """Once-per-pattern SpMV plan: device buffers + apply.  ``_bufs``
    holds the buffers in the JAX plan's order (see plan_from_numpy),
    except that a sell plan holds each class's compact pack in place of
    its slabs and keeps the host buffers it was made from in
    ``_host_bufs``."""
    m: int
    n: int
    mode: str
    flops: int
    bytes_min: int
    bytes_padded: int
    waste_ratio: float
    spill: int = 0                  # entries handled by the COO pass
    perm: np.ndarray = None         # sell: row/col permutation
    offsets: np.ndarray = None      # dia: the diagonals, sorted
    _bufs: tuple = ()
    _host_bufs: tuple = None        # sell: the planner's buffers
    _apply: Callable = None
    _kernel: Callable = None        # sell: permuted-space matvec

    @property
    def device(self) -> torch.device:
        return self._bufs[0].device

    def _vec(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=DTYPE,
                               device=self.device).contiguous()

    def apply(self, x) -> torch.Tensor:
        """y = A @ x on the plan's device."""
        return self._apply(*self._bufs, self._vec(x))[:self.m]

    def apply_permuted(self, xp) -> torch.Tensor:
        """y_perm = (P A P') @ x_perm for the SELL plan: the slab kernels
        + COO spill without the two n-sized permutation gathers.
        Iterative consumers permute once with ``perm`` and stay in
        permuted space."""
        if self._kernel is None:
            raise ValueError("apply_permuted is only for mode='sell'")
        return self._kernel(*self._bufs, self._vec(xp))[:self.m]

    def gaxpy(self, x, y) -> torch.Tensor:
        """y + A @ x — the reference cs_gaxpy contract, functional."""
        out = self._vec(y).clone()
        out[:self.m] += self.apply(x)
        return out

    def apply_many(self, X) -> torch.Tensor:
        """Y = A @ X for (n, k) multi-vectors, one apply per column."""
        X = torch.as_tensor(X, dtype=DTYPE, device=self.device)
        if X.dim() == 1:
            return self.apply(X)
        return torch.stack([self.apply(X[:, j]) for j in range(X.shape[1])],
                           dim=1)


# ------------------------------------------------------------ applies
def _ell_apply(vals, cols, x):
    """y = A @ x on the ELL slab (gather + fma)."""
    return (vals * x[cols]).sum(1)


def _seg_apply(m: int):
    def apply_fn(*bufs_and_x):
        *flat, x = bufs_and_x
        y = torch.zeros(m, dtype=DTYPE, device=x.device)
        for ci in range(len(flat) // 3):
            vals_d, cols_d, rid = flat[3 * ci:3 * ci + 3]
            y.index_add_(0, rid, (vals_d * x[cols_d]).sum(1))
        return y
    return apply_fn


def _sell_applies(n: int, identity: bool):
    def kernel_fn(sr_d, sc_d, sv_d, _p, _pi, *bufs_and_xp):
        """y_perm = C @ x_perm: the slab kernels (one launch per S class,
        each writing its blocks' rows) + the COO spill."""
        *flat, xp = bufs_and_xp
        y = torch.empty(n, dtype=DTYPE, device=xp.device)
        for ci in range(len(flat) // PACK):
            sell_spmv(*flat[PACK * ci:PACK * (ci + 1)], xp, y)
        if sr_d.numel():
            y.index_add_(0, sr_d, sv_d * xp[sc_d])
        return y

    def apply_fn(sr_d, sc_d, sv_d, pvec_d, piv_d, *bufs_and_x):
        *flat, x = bufs_and_x
        if identity:
            return kernel_fn(sr_d, sc_d, sv_d, pvec_d, piv_d, *flat, x)
        yp = kernel_fn(sr_d, sc_d, sv_d, pvec_d, piv_d, *flat, x[pvec_d])
        return yp[piv_d]

    return apply_fn, kernel_fn


# ------------------------------------------------------------ host plans
def _build_sell(A: CSCMatrix, max_s: int = None, max_tw: int = 4):
    """Plan the SELL-128 windowed-gather layout (the JAX package's
    planner, copied): identity or RCM permutation, rows->lanes slabs,
    per-block multi-tile window selection, out-of-window/overflow spill
    to a COO pass.  TPUSPARSE_SELL_KERNEL selects the slab layout (1
    default: entries in slot order; 2: each entry at the slab row of its
    x position's sublane, (pos >> 7) & 7).  Returns None when A is not
    square or empty."""
    if A.m != A.n or A.nnz == 0:
        return None
    version = int(os.environ.get("TPUSPARSE_SELL_KERNEL", "1"))
    if max_s is None:
        max_s = 8 if version == 2 else 4
    n = A.n
    from ..symbolic.rcm import rcm
    from ..core.ops import permute
    from ..core.perm import pinv as _pinv
    NB = round_up(n, 128) // 128

    def _pack(C):
        """Window selection + slab packing for one candidate ordering;
        returns every array the slab packing needs plus the spill
        count, so orderings can be compared before committing."""
        # CSR-style entries grouped by row (candidate coordinates)
        cols_of = np.repeat(np.arange(n, dtype=np.int64),
                            np.diff(C.indptr))
        rows_e, cols_e, vals_e = C.indices, cols_of, C.data
        order = np.argsort(rows_e, kind="stable")
        rows_e = rows_e[order]
        cols_e = cols_e[order]
        vals_e = vals_e[order]
        rptr = np.zeros(n + 2, np.int64)
        np.add.at(rptr, rows_e + 1, 1)
        rptr = np.cumsum(rptr)
        # window slots: each block gets TW independent x tiles (its
        # top-TW tiles by entry count), not a consecutive run.
        # TW = smallest count covering >=99.5% of entries, capped.
        tile_e = cols_e // TILE
        blk = rows_e // 128
        win = np.zeros((NB, max_tw), np.int64)
        topcnt = np.zeros((NB, max_tw), np.int64)
        for b in range(NB):
            lo, hi = rptr[b * 128], rptr[min((b + 1) * 128, n)]
            te = tile_e[lo:hi]
            if te.size == 0:
                continue
            vals_u, cnts = np.unique(te, return_counts=True)
            o = np.argsort(cnts)[::-1][:max_tw]
            win[b, :o.size] = vals_u[o]
            topcnt[b, :o.size] = cnts[o]
        tot = max(rows_e.size, 1)
        cum = np.cumsum(topcnt.sum(axis=0))
        TW = (int(np.argmax(cum >= tot * 0.995)) + 1 if rows_e.size
              else 1)
        TW = min(max(TW, 1), max_tw)
        win = np.ascontiguousarray(win[:, :TW])
        slot_e = np.full(rows_e.size, -1, np.int64)
        for j in range(TW):
            m = (tile_e == win[blk, j]) & (slot_e < 0)
            slot_e[m] = j
        pos = slot_e * TILE + (cols_e % TILE)
        ok = slot_e >= 0
        lane = rows_e % 128
        idx_in = np.where(ok)[0]
        if version == 2:
            q_of = (pos[idx_in] >> 7) & 7
            grp = rows_e[idx_in] * 8 + q_of
        else:
            grp = rows_e[idx_in]
        o2 = np.argsort(grp, kind="stable")
        gs = grp[o2]
        cc = np.zeros(gs.size, np.int64)
        if gs.size:
            newg = np.concatenate([[True], gs[1:] != gs[:-1]])
            gstart = np.where(newg)[0]
            glen = np.diff(np.concatenate([gstart, [gs.size]]))
            cc0 = np.arange(gs.size) - np.repeat(gstart, glen)
            cc[o2] = cc0
        if version == 2:
            s_of = cc
        else:
            s_of, q_of = cc // 8, cc % 8
        keep = s_of < max_s
        kept = idx_in[keep]
        # spill: out-of-window entries + per-slot overflow
        spm = np.ones(rows_e.size, bool)
        spm[kept] = False
        return dict(rows_e=rows_e, cols_e=cols_e, vals_e=vals_e,
                    win=win, TW=TW, blk=blk, lane=lane, pos=pos,
                    kept=kept, s_k=s_of[keep], q_k=q_of[keep],
                    sr=rows_e[spm], sc=cols_e[spm], sv=vals_e[spm])

    # identity-first ordering: a matrix that is already low-bandwidth
    # covers its windows without any permutation, and the one-shot apply
    # then needs no n-sized permutation gather.  RCM is engaged only
    # when the identity packing spills more than
    # TPUSPARSE_SELL_ID_SPILL_MAX (default 1%) of the entries.
    id_tol = float(os.environ.get("TPUSPARSE_SELL_ID_SPILL_MAX",
                                  "0.01"))
    pk = _pack(A)
    if pk["sr"].size <= id_tol * max(A.nnz, 1):
        p = np.arange(n, dtype=np.int64)
        piv = p
    else:
        p = rcm(A)
        piv = _pinv(p)
        pk = _pack(permute(A, piv, p, values=True))
    vals_e = pk["vals_e"]
    win, blk, lane, pos = pk["win"], pk["blk"], pk["lane"], pk["pos"]
    kept, s_k, q_k = pk["kept"], pk["s_k"], pk["q_k"]
    sr, sc, sv = pk["sr"], pk["sc"], pk["sv"]
    nsp = sr.size
    # per-block S class from the max used sub-step
    smax_blk = np.zeros(NB, np.int64)
    if kept.size:
        np.maximum.at(smax_blk, blk[kept], s_k + 1)
    Sb_arr = np.maximum(2 ** np.ceil(np.log2(
        np.maximum(smax_blk, 1))).astype(np.int64), 1)
    Sb_arr = np.minimum(Sb_arr, max_s)
    classes = sorted(set(Sb_arr.tolist()))
    flat = []            # (bids, winsel, pos, vals) per class
    slab_nnz = int(kept.size)
    bytes_padded = nsp * 16 + (2 * n) * 4 + n * 8
    slab_slots = 0
    for S in classes:
        bsel = np.where(Sb_arr == S)[0]
        NBc = bsel.size
        imap = np.full(NB, -1, np.int64)
        imap[bsel] = np.arange(NBc)
        pos_s = np.zeros((NBc, S, 8, 128), np.int32)
        vals_s = np.zeros((NBc, S, 8, 128), np.float32)
        msk = imap[blk[kept]] >= 0
        e, es, eq = kept[msk], s_k[msk], q_k[msk]
        pos_s[imap[blk[e]], es, eq, lane[e]] = pos[e]
        vals_s[imap[blk[e]], es, eq, lane[e]] = vals_e[e]
        flat += [bsel.astype(np.int32), win[bsel].astype(np.int32), pos_s,
                 vals_s]
        bytes_padded += pos_s.size * 8
        slab_slots += pos_s.size
    bufs = (sr.astype(np.int32), sc.astype(np.int32),
            sv.astype(np.float32), p.astype(np.int32), piv.astype(np.int32),
            *flat)
    return dict(perm=p, bufs=bufs, spill=int(nsp), slab_nnz=slab_nnz,
                slab_slots=slab_slots, bytes_padded=bytes_padded)


def _build_seg(A: CSCMatrix, cap: int = 32):
    """Segmented-sum SpMV for power-law row-degree distributions (the
    JAX package's planner, copied): rows are split into virtual rows of
    <= ``cap`` entries, each virtual row lands in the power-of-two width
    class of its true length (4/8/16/32), the per-class slabs run the
    plain gather+fma, and one scatter-add per class reduces the virtual
    partial sums into y.  Spill is zero by construction; padded bytes
    are bounded by 2x nnz regardless of the tail."""
    m, n = A.m, A.n
    if A.nnz == 0:
        return None
    cols_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    rows_e, cols_e, vals_e = A.indices, cols_of, A.data
    order = np.argsort(rows_e, kind="stable")
    rows_e, cols_e, vals_e = (rows_e[order], cols_e[order],
                              vals_e[order])
    deg = np.bincount(rows_e, minlength=m)
    # virtual rows: ceil(deg/cap) chunks per row
    nck = -(-deg // cap)
    nck0 = np.maximum(nck, 0)
    V = int(nck0.sum())
    v_row = np.repeat(np.arange(m, dtype=np.int64), nck0)
    starts = np.cumsum(deg) - deg
    v_idx = np.arange(V, dtype=np.int64)
    v_first = np.zeros(V, np.int64)
    if V:
        rstart = np.cumsum(nck0) - nck0
        v_first = starts[v_row] + (v_idx - rstart[v_row]) * cap
    v_len = np.minimum(deg[v_row] - (v_first - starts[v_row]), cap)
    # class = pow2 ceil of the virtual length, min 4
    cls = np.maximum(1 << np.ceil(np.log2(np.maximum(v_len, 1))
                                  ).astype(np.int64), 4)
    cls = np.minimum(cls, cap)
    classes = sorted(set(cls.tolist()))
    flat = []
    slots = 0
    for c in classes:
        sel = np.where(cls == c)[0]
        Vc = sel.size
        vals_s = np.zeros((Vc, c), np.float32)
        cols_s = np.zeros((Vc, c), np.int32)
        ii = np.repeat(np.arange(Vc, dtype=np.int64), v_len[sel])
        jj = np.concatenate([np.arange(L) for L in v_len[sel]]) \
            if Vc else np.zeros(0, np.int64)
        epos = np.repeat(v_first[sel], v_len[sel]) + jj
        vals_s[ii, jj] = vals_e[epos]
        cols_s[ii, jj] = cols_e[epos]
        flat += [vals_s, cols_s, v_row[sel].astype(np.int32)]
        slots += Vc * c
    return dict(bufs=tuple(flat), slots=slots,
                bytes_padded=slots * 8 + (m + n) * 4)


def _heavy_tail(A: CSCMatrix) -> bool:
    """Degree-distribution probe at plan time: a power-law tail makes
    both ELL (K = max degree) and SELL (max-substep slabs / COO spill)
    pay for the hubs; the segmented path caps padding per class."""
    if A.nnz == 0 or A.m == 0:
        return False
    deg = np.bincount(A.indices, minlength=A.m)
    med = max(float(np.median(deg[deg > 0])), 1.0)
    return float(deg.max()) >= 8.0 * med


# ------------------------------------------------------------ plans
def plan_from_numpy(meta: dict, bufs: Sequence[np.ndarray],
                    device="cuda") -> SpmvPlan:
    """A port plan from plan fields ``meta`` (keys of plan_to_numpy;
    ``perm`` for sell, ``offsets`` for dia) and host buffers in the JAX
    plan's ``_bufs`` order: sell ``sr, sc, sv, p, pinv`` then ``bids,
    win, pos, vals`` per S class; dia ``bands``; bell ``vals,
    tile_cols``; ell ``vals, cols``; seg ``vals, cols, rid`` per class.
    The buffers are copied to ``device`` as they are (dtypes kept),
    except a sell plan's slabs: each class goes to the device as its
    compact pack (kernels.sell_pack), and the plan keeps ``bufs``
    themselves, not copies, on the host for plan_to_numpy."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spmv_plan: device 'cuda' requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for the plain versions")
    meta = dict(meta)
    mode, m, n = meta["mode"], meta["m"], meta["n"]
    host = [np.asarray(b) for b in bufs]
    kept = None
    if mode == "sell":
        kept = tuple(host)
        host = host[:5] + [a for ci in range((len(host) - 5) // 4)
                           for a in sell_pack(*host[5 + 4 * ci:9 + 4 * ci])]
    tb = tuple(torch.tensor(b, device=dev) for b in host)
    kernel = None
    if mode == "dia":
        offs_d = torch.tensor(np.asarray(meta["offsets"], np.int32),
                              device=dev)

        def apply(bands, x):
            return dia_spmv(bands, offs_d, x)
    elif mode == "bell":
        def apply(vals, tile_cols, x):
            return bell_spmv(vals, tile_cols, x, m)
    elif mode == "sell":
        perm = np.asarray(meta["perm"])
        apply, kernel = _sell_applies(
            n, np.array_equal(perm, np.arange(n)))
    elif mode == "seg":
        apply = _seg_apply(m)
    elif mode == "ell":
        apply = _ell_apply
    else:
        raise ValueError(f"unknown SpMV mode {mode!r}")
    fields = {f: meta.get(f) for f in _FIELDS}
    fields["spill"] = fields["spill"] or 0
    return SpmvPlan(**fields, _bufs=tb, _host_bufs=kept, _apply=apply,
                    _kernel=kernel)


def plan_to_numpy(plan: SpmvPlan):
    """(meta, bufs): the plan's fields and its buffers as host arrays, in
    the JAX plan's ``_bufs`` order (see plan_from_numpy); for a sell
    plan, the host buffers it was made from."""
    meta = {f: getattr(plan, f) for f in _FIELDS}
    if plan._host_bufs is not None:
        return meta, list(plan._host_bufs)
    return meta, [b.detach().cpu().numpy() for b in plan._bufs]


def spmv_plan(A: CSCMatrix, mode: str = "auto",
              device="cuda") -> SpmvPlan:
    """Plan a device SpMV for the pattern of A on ``device`` (default
    the card; "cpu" runs the kernels' plain versions).

    mode: 'ell' (gather path), 'bell' (128x128 tile kernel), 'dia'
    (gather-free banded kernel), 'sell' (RCM + windowed-gather kernel,
    the general-pattern path), 'seg' (row-split segmented sum for
    power-law degree tails), or 'auto' (the JAX package's rules).
    """
    if mode == "auto":
        mode = "ell"
        if A.nnz > 0:
            # DIA when the diagonal structure is compact: gather-free
            offs = dia_offsets(A)
            if (offs.size <= 64
                    and A.nnz / max(offs.size * A.m, 1) > 0.2):
                mode = "dia"
        if mode == "ell" and A.nnz > 0:
            # quick occupancy probe on the 128x128 tiling
            nbc = round_up(A.n, 128) // 128
            cols_of = np.repeat(np.arange(A.n), np.diff(A.indptr))
            keys = (A.indices // 128) * nbc + cols_of // 128
            ntiles = np.unique(keys).size
            occ = A.nnz / max(ntiles * 128 * 128, 1)
            if occ > 0.25:
                mode = "bell"
        if mode == "ell" and A.nnz > 0 and _heavy_tail(A):
            mode = "seg"           # power-law degree tail
        elif (mode == "ell" and A.m == A.n
                and A.nnz > 0 and A.nnz / A.n <= 32):
            mode = "sell"          # general irregular pattern
    base = dict(m=A.m, n=A.n)
    nnz = A.nnz
    if mode == "seg":
        plan = _build_seg(A)
        if plan is None:
            mode = "ell"
        else:
            return plan_from_numpy(dict(
                base, mode="seg", flops=2 * nnz,
                bytes_min=nnz * 8 + (A.m + A.n) * 4,
                bytes_padded=plan["bytes_padded"],
                waste_ratio=1.0 - nnz / max(plan["slots"], 1), spill=0),
                plan["bufs"], device)
    if mode == "sell":
        plan = _build_sell(A)
        if plan is None:
            mode = "ell"
        else:
            return plan_from_numpy(dict(
                base, mode="sell", flops=2 * nnz,
                bytes_min=nnz * 8 + (A.m + A.n) * 4,
                bytes_padded=plan["bytes_padded"],
                waste_ratio=1.0 - plan["slab_nnz"]
                / max(plan["slab_slots"], 1),
                spill=plan["spill"], perm=plan["perm"]),
                plan["bufs"], device)
    if mode == "dia":
        D = to_dia(A)
        return plan_from_numpy(dict(
            base, mode="dia", flops=D.flops, bytes_min=D.bytes_min,
            bytes_padded=D.bytes_padded, waste_ratio=D.waste_ratio,
            offsets=D.offsets), (D.bands,), device)
    if mode == "bell":
        B = to_bell(A, bm=128, bk=128)
        return plan_from_numpy(dict(
            base, mode="bell", flops=B.flops,
            bytes_min=A.nnz * 8 + (A.m + A.n) * 4,
            bytes_padded=B.vals.size * 4 + B.tile_cols.size * 4
            + (A.m + A.n) * 4,
            waste_ratio=B.waste_ratio), (B.vals, B.tile_cols), device)
    if mode != "ell":
        raise ValueError(f"unknown SpMV mode {mode!r}")
    E = to_ell(A)
    return plan_from_numpy(dict(
        base, mode="ell", flops=E.flops, bytes_min=E.bytes_min,
        bytes_padded=E.bytes_padded,
        waste_ratio=1.0 - A.nnz / max(E.vals.size, 1)),
        (E.vals, E.cols), device)


def gaxpy_device(A: CSCMatrix, x, y, device="cuda") -> np.ndarray:
    """One-shot device gaxpy y + A @ x (plans, runs, returns numpy)."""
    plan = spmv_plan(A, device=device)
    return plan.gaxpy(x, y).cpu().numpy()
