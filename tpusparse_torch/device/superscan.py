"""Superscan supernodal Cholesky in PyTorch: factor and solve.

Port of the device half of tpusparse/device/superscan.py.  The plan is
the JAX package's, made by the numpy planner copied into
``superscan_plan``; its schedules arrive here as index arrays, uploaded
once per ``factor()`` (int64, on the factor's device).

Factor: a host loop over each segment's steps (JAX: one ``lax.scan``
per segment).  Per step, in sorted key order: the update phases (row
gathers masked with ``torch.where``, a batched GEMM, a row or element
scatter-add), then the chol phases (tril-symmetrize, batched Cholesky of
the W x W diagonal blocks by ``kernels.chol_tiles``), then the trsm
phases (``kernels.trsm_tiles_batched``).  Each phase runs at the batch
size of the branch JAX executes, the step's ladder rung, read from the
host arrays: the loop never waits on the device.  The pools are updated
in place (``index_add_``, ``index_copy_``) where JAX rebuilt them
functionally.

Left out of the JAX body: the per-step gather chunking
(superscan.py:1585-1599, ``_cap``; one chunk here), the compiled-program
cache (``_pools_sig``, compilepool.py, :1812-1846) and the ``shard_fn``
hooks.  The aggregated ``updg``/``upda`` phases (TPUSPARSE_AGG=1, a
measured negative result) raise NotImplementedError.

Solve: the same segments with diagonal solves and od GEMVs, forward
then backward, in f32, then host f64 iterative refinement.  The copied
``_solve_xs`` has no per-step slot cap (superscan.py:1895-1944, the
relay's TPUSPARSE_SOLVE_SLOT_CAP, default 1024): the cap pads every key
of a segment into every sub-step, which at the g=48 3D Laplacian grows
the solve schedule from 248 MB to 9.7 GB.  So the port's schedule is
the JAX one under TPUSPARSE_SOLVE_SLOT_CAP=0.  The byte split along the
step axis (TPUSPARSE_SOLVE_XS_MAX_BYTES) stays.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..core.matrix import CSCMatrix
from ..core.perm import ipvec, pvec

from .config import DTYPE, IDX_DTYPE
from .kernels import chol_tiles, trsm_tiles_batched
from .refine import refine
from .superscan_plan import SuperscanPlan, _solve_xs, plan_superscan

__all__ = ["SuperscanCholesky", "plan_superscan", "pools_from_numpy",
           "pools_to_numpy"]

Pools = Dict[int, torch.Tensor]
Sched = Dict[tuple, Dict[str, torch.Tensor]]


def pools_from_numpy(pools: Dict[int, np.ndarray], device) -> Pools:
    """Copy host pools ({pool width: (rows, width) array}) to ``device``
    as f32 tensors; never shares memory with the arrays."""
    return {int(pw): torch.tensor(np.asarray(v), dtype=DTYPE, device=device)
            for pw, v in pools.items()}


def pools_to_numpy(pools: Pools) -> Dict[int, np.ndarray]:
    return {pw: v.detach().cpu().numpy() for pw, v in pools.items()}


class _Packed:
    """Index schedules (one {key: {name: int array}} per segment) packed
    into one host buffer, so that an upload is one copy and one int64
    cast instead of one of each per array (10,488 arrays in the
    canonical factor schedule)."""

    def __init__(self, scheds: List[Dict[tuple, Dict[str, np.ndarray]]]):
        arrs = [a for xs in scheds for d in xs.values() for a in d.values()]
        self.layout = [{k: {nm: a.shape for nm, a in d.items()}
                        for k, d in xs.items()} for xs in scheds]
        self.host = torch.from_numpy(
            np.concatenate([a.ravel() for a in arrs]) if arrs
            else np.zeros(0, np.int32))

    def upload(self, device) -> List[Sched]:
        if device.type == "cuda" and not self.host.is_pinned():
            self.host = self.host.pin_memory()
        flat = self.host.to(device, non_blocking=True).to(IDX_DTYPE)
        out, off = [], 0
        for lay in self.layout:
            xs = {}
            for k, d in lay.items():
                xs[k] = {}
                for nm, shape in d.items():
                    size = int(np.prod(shape))
                    xs[k][nm] = flat[off:off + size].view(shape)
                    off += size
            out.append(xs)
        return out


class _Consts:
    """Per-device constants of the step loops: ``arange(W)`` and the f32
    identity per width, and the f32 zero that ``torch.where`` masks with
    (a Python scalar there costs a host tensor and a fill launch per
    call)."""

    def __init__(self, device):
        self.zero = torch.zeros((), dtype=DTYPE, device=device)
        self._ar: Dict[int, torch.Tensor] = {}
        self._eye: Dict[int, torch.Tensor] = {}
        self.device = device

    def arange(self, W: int) -> torch.Tensor:
        a = self._ar.get(W)
        if a is None:
            a = self._ar[W] = torch.arange(W, device=self.device)
        return a

    def eye(self, W: int) -> torch.Tensor:
        e = self._eye.get(W)
        if e is None:
            e = self._eye[W] = torch.eye(W, dtype=DTYPE, device=self.device)
        return e


# ------------------------------------------------------------------ factor
def _upd(pools: Pools, key: tuple, a: Dict[str, torch.Tensor],
         c: _Consts) -> None:
    """delta = L1 @ L0^T from pool pd, scatter-subtracted into pool ps
    (JAX: superscan.py:1653-1699).  Padded slots carry -1: their rows
    gather row 0 under a false mask, so they add exact zeros to row 0."""
    kind, pd, ps, H, Wd, Ws = key
    flat_d = pools[pd][:, :Wd]
    src, tgt, l0i = a["src"], a["tgt"], a["l0"]
    l1 = torch.where((src >= 0)[..., None], flat_d[src.clamp(min=0)],
                     c.zero)
    l0 = torch.where((l0i >= 0)[..., None], flat_d[l0i.clamp(min=0)],
                     c.zero)
    delta = torch.bmm(l1, l0.mT)                          # (bs, H, Ws)
    acc = pools[ps]
    if kind == "upds":
        # column-compressed: element scatter at (target row, col) pairs,
        # as one index_add_ over the flat pool (index_put_ with
        # accumulate=True sorts its indices first)
        flat = tgt.clamp(min=0)[:, :, None] * ps + a["cmap"][:, None, :]
        acc.view(-1).index_add_(0, flat.reshape(-1), delta.reshape(-1),
                                alpha=-1)
    else:
        # JAX pads delta to the pool width with zeros; adding into the
        # first Ws columns only is the same sum
        acc[:, :Ws].index_add_(0, tgt.clamp(min=0).reshape(-1),
                               delta.reshape(-1, Ws), alpha=-1)


def _chol(pools: Pools, key: tuple, a: Dict[str, torch.Tensor],
          c: _Consts) -> None:
    """Batched Cholesky of the diagonal blocks, written back as full pool
    rows (JAX: superscan.py:1712-1746).  Padded slots factor the identity
    rows, and rewrite them with equal values."""
    _, pw, W = key
    acc = pools[pw]
    idx = a["dbase"][:, None] + c.arange(W)               # (bs, W)
    P = acc[:, :W][idx]
    sym = torch.tril(P) + torch.tril(P, -1).mT
    Lkk = chol_tiles(sym.contiguous())
    acc.index_copy_(0, idx.reshape(-1), F.pad(Lkk, (0, pw - W))
                    .reshape(-1, pw))


def _trsm(pools: Pools, key: tuple, a: Dict[str, torch.Tensor],
          c: _Consts) -> None:
    """Y = X @ Lkk^-T for each slot's od rows, written back as full pool
    rows (JAX: superscan.py:1758-1794).  Padded rows point at the dump
    row, which no real phase reads."""
    _, pw, H, W = key
    acc = pools[pw]
    sl = acc[:, :W]
    rows = a["rows"]
    Lkk = sl[a["dbase"][:, None] + c.arange(W)]           # (bs, W, W)
    X = sl[rows]                                          # (bs, H, W)
    Y = trsm_tiles_batched(Lkk, X)
    acc.index_copy_(0, rows.reshape(-1), F.pad(Y, (0, pw - W))
                    .reshape(-1, pw))


_FACTOR_PHASES = ((("upd", "upds"), _upd), (("chol",), _chol),
                  (("trsm",), _trsm))


def _segment_factor(seg, xs: Sched, pools: Pools, c: _Consts,
                    phases=_FACTOR_PHASES) -> None:
    """One segment's step loop over ``phases`` ((kinds, run) pairs, run in
    that order each step).  Steps past ``hi - lo`` are the cluster padding
    of the last chunk, whose indices are all no-ops, so they are not
    run."""
    keys = sorted(xs)
    for step in range(seg.hi - seg.lo):
        for kinds, run in phases:
            for key in keys:
                if key[0] not in kinds:
                    continue
                arrs = xs[key]
                lad = seg.ladders.get(key)
                bs = (next(iter(arrs.values())).shape[1] if lad is None
                      else lad[int(seg.lvls[key][step])])
                if bs == 0:
                    continue                       # empty rung: no launch
                a = {nm: v[step, :bs] for nm, v in arrs.items()}
                run(pools, key, a, c)


def _factor(plan: SuperscanPlan, pools: Pools,
            packed: _Packed = None, phases=_FACTOR_PHASES) -> Pools:
    """Factor ``pools`` (the plan's initial pools, on their device) in
    place and return them.  ``packed`` is the plan's factor schedule
    (``_Packed`` of every segment's xs), uploaded here before the step
    loop; ``phases`` as in ``_segment_factor``."""
    agg = sorted({k[0] for s in plan.segments for k in s.xs}
                 & {"updg", "upda"})
    if agg:
        raise NotImplementedError(
            f"superscan phases {agg} (TPUSPARSE_AGG=1) are not ported")
    device = next(iter(pools.values())).device
    segs = [seg for seg in plan.segments if seg.xs]
    if packed is None:
        packed = _Packed([seg.xs for seg in segs])
    c = _Consts(device)
    for seg, xs in zip(segs, packed.upload(device)):
        _segment_factor(seg, xs, pools, c, phases)
    return pools


# ------------------------------------------------------------------- solve
def _diag_solve(pools: Pools, key: tuple, a, xpad: torch.Tensor,
                c: _Consts, transpose: bool) -> None:
    """x[cols] <- Lkk^-1 x[cols] (forward) or Lkk^-T x[cols] (backward);
    JAX: superscan.py:2015-2027 and :2059-2071."""
    _, pw, W = key
    Lkk = pools[pw][:, :W][a["dbase"][:, None] + c.arange(W)]  # (U,W,W)
    cols = a["cols"]
    xc = xpad[cols][..., None]
    if transpose:
        y = torch.linalg.solve_triangular(Lkk.mT, xc, upper=True)
    else:
        y = torch.linalg.solve_triangular(Lkk, xc, upper=False)
    xpad.index_copy_(0, cols.reshape(-1), y.reshape(-1))


def _od_solve(pools: Pools, key: tuple, a, xpad: torch.Tensor,
              c: _Consts, backward: bool) -> None:
    """The od GEMV of each trsm slot, scatter-subtracted into x; JAX:
    superscan.py:2028-2042 and :2044-2058.  Rows whose target is the pad
    entry n are masked out with torch.where."""
    _, pw, H, W = key
    nn = xpad.shape[0] - 1
    mask = a["tgt"] < nn
    Y = torch.where(mask[..., None], pools[pw][:, :W][a["rows"]], c.zero)
    if backward:
        xod = torch.where(mask, xpad[a["tgt"]], c.zero)
        delta = torch.bmm(Y.mT, xod[..., None])           # (U, W, 1)
        xpad.index_add_(0, a["cols"].reshape(-1), delta.reshape(-1),
                        alpha=-1)
    else:
        xc = xpad[a["cols"]]
        delta = torch.bmm(Y, xc[..., None])               # (U, H, 1)
        xpad.index_add_(0, a["tgt"].reshape(-1), delta.reshape(-1),
                        alpha=-1)


def _segment_solve(xs: Sched, pools: Pools, xpad: torch.Tensor,
                   c: _Consts, backward: bool) -> None:
    keys = sorted(xs)
    ck = [k for k in keys if k[0] == "chol"]
    tk = [k for k in keys if k[0] == "trsm"]
    nn = xpad.shape[0] - 1
    steps = next(iter(xs[keys[0]].values())).shape[0]
    for step in (range(steps - 1, -1, -1) if backward else range(steps)):
        def at(k):
            return {nm: v[step] for nm, v in xs[k].items()}
        if not backward:
            for k in ck:
                _diag_solve(pools, k, at(k), xpad, c, False)
            for k in tk:
                _od_solve(pools, k, at(k), xpad, c, False)
        else:
            for k in tk:
                _od_solve(pools, k, at(k), xpad, c, True)
            for k in ck:
                _diag_solve(pools, k, at(k), xpad, c, True)
        xpad[nn] = 0.0


class SuperscanCholesky:
    """Plan + factor + solve object (same contracts as the JAX
    ``SuperscanCholesky``): f32 factor on ``device``, f64 refined solves.

    ``device`` defaults to "cuda", so a machine without a card fails here
    instead of running on the CPU; the CPU runs the plain versions of the
    kernels."""

    def __init__(self, A: CSCMatrix, order: int = 1, wmax: int = None,
                 tau: float = 0.9, small_w: int = 8,
                 max_segments: int = 10, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SuperscanCholesky: device 'cuda' requested "
                               "but torch.cuda.is_available() is False")
        self.A = A
        self.plan = plan_superscan(A, order=order, wmax=wmax, tau=tau,
                                   small_w=small_w,
                                   max_segments=max_segments)
        self.pools = None
        self._factor_sched: _Packed = None
        self._solve_sched: List[Sched] = None
        self._consts = _Consts(self.device)

    def load_pools(self, pools: Dict[int, np.ndarray]) -> None:
        """Take factored (or initial) pools from the host, e.g. the JAX
        package's ``{pw: np.asarray(v) for pw, v in F.pools.items()}``."""
        self.pools = pools_from_numpy(pools, self.device)

    def factor(self) -> bool:
        plan = self.plan
        if self._factor_sched is None:
            self._factor_sched = _Packed([s.xs for s in plan.segments
                                          if s.xs])
        pools = _factor(plan, pools_from_numpy(plan.pool_init, self.device),
                        self._factor_sched)
        # the one host sync: finiteness over the real rows only (the
        # identity and dump rows below them are not checked)
        ok = bool(torch.stack([torch.isfinite(v[:plan.pool_rows[pw]]).all()
                               for pw, v in pools.items()]).all())
        if ok:
            self.pools = pools
        return ok

    def _sched(self) -> List[Sched]:
        """The solve schedule, built and uploaded once, kept on the
        device."""
        if self._solve_sched is None:
            self._solve_sched = _Packed(
                [xs for xs in _solve_xs(self.plan) if xs]
            ).upload(self.device)
        return self._solve_sched

    def _run_solve(self, xpad: torch.Tensor) -> torch.Tensor:
        sched = self._sched()
        for xs in sched:
            _segment_solve(xs, self.pools, xpad, self._consts, False)
        for xs in reversed(sched):
            _segment_solve(xs, self.pools, xpad, self._consts, True)
        return xpad

    def _solve_f32(self, b: np.ndarray) -> np.ndarray:
        plan = self.plan
        bp = pvec(plan.perm, np.asarray(b, np.float64))
        xpad = np.zeros(plan.n + 1, dtype=np.float32)
        xpad[:plan.n] = bp
        out = self._run_solve(torch.from_numpy(xpad).to(self.device))
        xp = out.cpu().numpy().astype(np.float64)[:plan.n]
        return ipvec(plan.perm, xp)

    def solve(self, b: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        if self.pools is None and not self.factor():
            raise ValueError("matrix is not positive definite")
        return refine(self.A, self._solve_f32, b, iters=refine_iters)

    def extract_L(self) -> CSCMatrix:
        """The factored pools as a host CSC L (permuted coordinates,
        diagonal-first columns, true pattern only), as the JAX
        ``SuperscanCholesky.extract_L`` gives it."""
        if self.pools is None:
            raise ValueError("factor() first")
        plan = self.plan
        host = pools_to_numpy(self.pools)
        rows, vals, cnt = [], [], np.zeros(plan.n + 1, np.int64)
        for pl in sorted(plan.panels, key=lambda pl: pl.c0):
            buf = host[pl.pool]
            for c in range(pl.w):
                j = pl.c0 + c
                rows += [np.arange(j, pl.c0 + pl.w), pl.rows]
                vals += [buf[pl.rbase + c + np.arange(pl.w - c), c],
                         buf[pl.rbase + pl.W + np.arange(pl.rows.size), c]]
                cnt[j + 1] = pl.w - c + pl.rows.size
        return CSCMatrix(plan.n, plan.n, np.cumsum(cnt),
                         np.concatenate(rows).astype(np.int64),
                         np.concatenate(vals).astype(np.float64))
