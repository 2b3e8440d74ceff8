"""Superscan supernodal Cholesky in PyTorch: factor and solve.

Port of the device half of tpusparse/device/superscan.py.  The plan is
the JAX package's, made by the numpy planner copied into
``superscan_plan``; its schedules arrive here as index arrays, uploaded
once per plan (int64, on the factor's device, ``_Packed``) and kept
there.  Each ``factor()`` copies the plan's initial pools to fresh
device pools from f32 host copies made once per plan, pinned on a card
(``_host_pools``).

Factor: a host loop over each segment's steps (JAX: one ``lax.scan``
per segment).  Per step, in JAX's order: the update phases (two row
gathers, a batched GEMM, a row or element scatter-add; with
TPUSPARSE_AGG=1 first the aggregated ``updg`` GEMMs into the scratch and
the ``upda`` applies out of it), then the chol phases (tril-symmetrize,
batched Cholesky of the W x W diagonal blocks by ``kernels.chol_tiles``),
then the trsm phases
(``kernels.trsm_tiles_batched``).  Each phase runs at the batch size of
the branch JAX executes, the step's ladder rung, read from the host
arrays: the loop never waits on the device.  The aggregated phases have
no ladder (JAX runs them at full capacity, masked); here each runs at
its step's active unit count, counted once on the host (``_fills``):
the units past it only write the dump row or add zeros.  The pools are
updated in place (``index_add_``, ``index_copy_``) where JAX rebuilt
them functionally.  Where JAX masks the update phases' padded indices
(-1), the port resolves them once per plan on the host when it packs the
schedule (``_resolve``, which the LU shares): a padded gather reads a
row that stays zero, a padded target adds into a row that no phase
reads.

Left out of the JAX body: the per-step gather chunking
(superscan.py:1585-1599, ``_cap``; one chunk here), the compiled-program
cache (``_pools_sig``, compilepool.py, :1812-1846) and the ``shard_fn``
hooks.

Solve: the same steps with diagonal solves and od GEMMs, forward then
backward, in f32 for all k right-hand sides at once as an (n + 1, k)
tensor (JAX vmaps the segment solve over them), then host f64 iterative
refinement (``refine``; ``refine_many`` for ``solve_many``).  JAX runs
every key of every step at full capacity; here the schedule keeps only
the (step, key) pairs with a real slot, each cut to its last real slot
(``_solve_steps``, once per plan on the host): padded slots only touch
the pad row n.  One sweep serves both superscan engines: the Cholesky
here and ``superscan_lu``'s LU each build their schedule with
``_solve_schedule`` and sweep it with ``_solve_sweep``, which walks each
step with ``_step_solve`` and takes the engine's diagonal solve and od
GEMMs from its caller.
``solve_host`` solves on the downloaded factor with the host trisolves.
Spans (``utils.profiling``, recorded only under a profiler or
``recording()``) mark the plan, the factor with its uploads, segments,
phases and check, the solve with its sweeps, and the block solve
(``solve_many``) with its sweeps and ``refine_many``'s residuals; the
shared factor and solve loops take their spans' names from their caller
(``_Phases.name``, ``_solve_sweep``'s ``name``).  The copied
``_solve_xs`` has no per-step slot cap (superscan.py:1895-1944, the
relay's TPUSPARSE_SOLVE_SLOT_CAP, default 1024): the cap pads every key
of a segment into every sub-step, which at the g=48 3D Laplacian grows
the solve schedule from 248 MB to 9.7 GB.  So the port's schedule is
the JAX one under TPUSPARSE_SOLVE_SLOT_CAP=0.  The byte split along the
step axis (TPUSPARSE_SOLVE_XS_MAX_BYTES) stays.

Updown: the cs_updown recurrence of the fixed-tile engine
(``chol_tpu._updown``) over the pools concatenated into one flat vector,
as JAX runs its ``_updown_scan`` there; the pools are views into that
vector afterwards.  The relay's compiled-program cache (``_UD_JIT``) is
left out.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.matrix import CSCMatrix, csc_from_dense
from ..core.ops import add, multiply, transpose
from ..core.perm import ipvec, pvec
from ..numeric.trisolve import lsolve, ltsolve
from ..utils.profiling import Metrics, span
from ..utils.profiling import add as count

from .batching import units, whole
from .chol_tpu import _updown
from .config import DTYPE, IDX_DTYPE
from .kernels import chol_tiles, trsm_tiles_batched
from .refine import refine
from .refine_many import refine_many
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


_CHUNK = 1 << 24            # schedule entries an upload casts at a time


class _Packed:
    """Index schedules (one {key: {name: int array}} per segment) packed
    into one int32 host buffer, so that an upload is a few chunked
    copies into one int64 tensor instead of a copy and a cast per array
    (10,488 arrays in the canonical factor schedule).  ``upload`` gives
    the views of a new copy on a device; ``resident`` keeps the first
    copy it makes (``scheds``) and drops the host buffer.  ``fills``
    are the aggregated phases' counts (``_fills``) of each schedule,
    counted from ``scheds`` where not given."""

    def __init__(self, scheds: List[Dict[tuple, Dict[str, np.ndarray]]],
                 fills: List[Dict[tuple, np.ndarray]] = None):
        self.fills = fills or [_fills(xs) for xs in scheds]
        arrs = [a for xs in scheds for d in xs.values() for a in d.values()]
        self.layout = [{k: {nm: a.shape for nm, a in d.items()}
                        for k, d in xs.items()} for xs in scheds]
        self.host = torch.from_numpy(
            np.concatenate([a.ravel() for a in arrs]) if arrs
            else np.zeros(0, np.int32))
        self.nbytes = self.host.nbytes
        self.scheds: List[Sched] = None

    def upload(self, device) -> List[Sched]:
        """The schedules as int64 views of one new tensor on ``device``.
        Each ``_CHUNK`` entries cross as int32 and are cast there, so
        the device never holds an int32 copy of the whole buffer."""
        flat = torch.empty(self.host.numel(), dtype=IDX_DTYPE, device=device)
        for lo in range(0, flat.numel(), _CHUNK):
            flat[lo:lo + _CHUNK].copy_(self.host[lo:lo + _CHUNK].to(device))
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

    def resident(self, device) -> List[Sched]:
        """The views of the copy kept on ``device``, uploaded at the first
        call, after which the host buffer is dropped."""
        if self.scheds is None:
            self.scheds = self.upload(device)
            self.host = None
        return self.scheds


def _host_pools(pools: dict, device) -> Dict:
    """f32 host tensors of ``pools`` ({key: array}), made once per plan
    for ``_pools_on`` to copy from; pinned where ``device`` is a card."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
           for k, v in pools.items()}
    if torch.device(device).type == "cuda":
        out = {k: v.pin_memory() for k, v in out.items()}
    return out


def _pools_on(host: dict, device) -> Dict:
    """New pools on ``device`` holding the values of ``_host_pools``'
    tensors, which they never share.  From pinned memory the copies are
    queued and the host goes on."""
    return {k: torch.empty(v.shape, dtype=DTYPE, device=device)
            .copy_(v, non_blocking=True) for k, v in host.items()}


SCRATCH_LANES = 128         # the scratch's row width, as JAX pads it


def _fill(act: np.ndarray) -> np.ndarray:
    """One past the last active slot of each step of a (steps, slots)
    mask; 0 where a step has none."""
    return np.where(act.any(axis=1),
                    act.shape[1] - np.argmax(act[:, ::-1], axis=1), 0)


def _fills(xs: Dict[tuple, Dict[str, np.ndarray]]) -> Dict[tuple,
                                                           np.ndarray]:
    """{key: active units a step} of one segment's aggregated phases.
    The planner packs their units from slot 0 of each step
    (``_pinned_slots``) and gives them no ladder; a slot is active where
    any of its rows is a real index."""
    out = {}
    for key, d in xs.items():
        if key[0] in ("updg", "upda"):
            out[key] = _fill(
                (d["src" if key[0] == "updg" else "srd"] >= 0).any(axis=2))
    return out


def _pad_rows(plan, pw: int) -> tuple:
    """(dump, zero): two rows of pool pw's dump block, the plan's last
    rows ([real rows][pw identity rows][dump rows],
    ``superscan_plan.plan_superscan``), past the first dump row, which
    the trsm phase's padded rows read and write.  No phase reads the
    dump row, and no phase writes the zero row, which so reads 0 for a
    whole factor."""
    dump = plan.pool_rows[pw] + pw + 1
    return dump, dump + 1


def _resolve(plan, targets=("tgt",)) -> tuple:
    """The factor schedule of ``plan`` (every segment's xs), packed
    (``_Packed``) with the update keys' padding resolved, on the host,
    once per plan: in copies of their arrays, each -1 of ``src`` and
    ``l0`` points at the zero row of pool pd, each -1 of an "upd" or
    "upds" key's ``targets`` (the LU's: "tgt" and "tgtu") at the dump
    row of pool ps (``_pad_rows``), and an "upds" key's targets are
    stored times ps, the flat index of their row.  The plan's arrays,
    JAX's bit for bit, stay as they are, and the aggregated phases'
    counts (``_fills``) are read from them.  Returns (the packed
    schedule, the count of entries redirected)."""
    segs = [seg.xs for seg in plan.segments if seg.xs]
    out, remapped = [], 0
    for seg in segs:
        xs = {}
        for key, d in seg.items():
            kind, pd = key[:2]
            if kind in ("upd", "upds", "updg"):
                d = dict(d)
                zero = _pad_rows(plan, pd)[1]
                rows = [("src", zero), ("l0", zero)]
                if kind != "updg":
                    ps = key[2]
                    rows += [(nm, _pad_rows(plan, ps)[0]) for nm in targets]
                for nm, row in rows:
                    v = d[nm].copy()
                    pad = v < 0
                    v[pad] = row
                    remapped += int(np.count_nonzero(pad))
                    if kind == "upds" and nm in targets:
                        if plan.pool_init[ps].size >= 2 ** 31:
                            v = v.astype(np.int64)   # flat index past int32
                        v = v * ps
                    d[nm] = v
            xs[key] = d
        out.append(xs)
    return _Packed(out, [_fills(xs) for xs in segs]), remapped


def _scratch(rows: int, device) -> torch.Tensor:
    """The aggregated phases' (rows, SCRATCH_LANES) f32 scratch; its last
    row is the dump row of padded ``updg`` units.  A row is read only in
    the step that wrote it, so one buffer serves every segment."""
    return torch.zeros((rows, SCRATCH_LANES), dtype=DTYPE, device=device)


class _Consts:
    """Per-device constants of the step loops: ``arange(W)`` and the f32
    identity per width, and the f32 zero that ``torch.where`` masks with
    (a Python scalar there costs a host tensor and a fill launch per
    call); and the factor's scratch (``_scratch``), None without
    aggregated phases."""

    def __init__(self, device):
        self.zero = torch.zeros((), dtype=DTYPE, device=device)
        self.scratch: torch.Tensor = None
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
def _upd_delta(pools: Pools, key: tuple, a: Dict[str, torch.Tensor],
               c: _Consts) -> tuple:
    """(delta,) = L1 @ L0^T from pool pd for the units of ``a`` (JAX:
    superscan.py:1653-1699; for "updg", :1608-1623): two gathers and a
    ``bmm``.  The schedule is ``_resolve``'s: a padded slot gathers the
    zero row, so its delta is the zero JAX masks it to."""
    flat_d = pools[key[1]][:, :key[-2]]    # upd/upds and updg keys alike
    return (torch.bmm(flat_d[a["src"]], flat_d[a["l0"]].mT),)  # (bs,H,Ws)


def _upd_apply(pools: Pools, key: tuple, a: Dict[str, torch.Tensor],
               delta: torch.Tensor) -> None:
    """Scatter-subtracts the units' delta into pool ps, one
    ``index_add_``; padded rows add into the dump row (``_resolve``)."""
    kind, pd, ps, H, Wd, Ws = key
    acc = pools[ps]
    if kind == "upds":
        # column-compressed: element scatter at (target row, col) pairs,
        # as one index_add_ over the flat pool (index_put_ with
        # accumulate=True sorts its indices first); tgt is stored times
        # ps, the flat index of its row
        flat = a["tgt"][:, :, None] + a["cmap"][:, None, :]
        acc.view(-1).index_add_(0, flat.reshape(-1), delta.reshape(-1),
                                alpha=-1)
    else:
        # JAX pads delta to the pool width with zeros; adding into the
        # first Ws columns only is the same sum
        acc[:, :Ws].index_add_(0, a["tgt"].reshape(-1),
                               delta.reshape(-1, Ws), alpha=-1)


def _agg_write(key: tuple, a: Dict[str, torch.Tensor],
               delta: torch.Tensor, c: _Consts) -> None:
    """Writes an "updg" delta into the scratch rows ``swr`` (JAX:
    superscan.py:1624-1631); a padded row (-1) goes to the dump row.
    JAX pads the delta with zeros to the scratch's 128 lanes; only the
    first Ws lanes are written here, and no "upda" reads past them
    (tests/test_torch_superscan.py starts the scratch full of NaN)."""
    Ws = key[-1]
    swr = a["swr"]
    rows = torch.where(swr >= 0, swr, c.scratch.shape[0] - 1)
    c.scratch[:, :Ws].index_copy_(0, rows.reshape(-1),
                                  delta.reshape(-1, Ws))


def _agg_apply(pools: Pools, key: tuple, a: Dict[str, torch.Tensor],
               c: _Consts) -> None:
    """Scatter-subtracts each unit's (H, Ws) sub-block of the scratch
    (rows ``srd``, lanes ``bcol``; -1 masked to zero) into pool ps at
    (``tgt``, ``cmap``) (JAX: superscan.py:1632-1648), as one
    ``index_add_`` over the flat pool; masked entries add zeros to row
    0."""
    ps = key[1]
    srd, bcol = a["srd"], a["bcol"]
    sub = c.scratch[srd.clamp(min=0)[:, :, None],
                    bcol.clamp(min=0)[:, None, :]]        # (bs, H, Ws)
    sub = torch.where((srd >= 0)[:, :, None] & (bcol >= 0)[:, None, :],
                      sub, c.zero)
    flat = a["tgt"].clamp(min=0)[:, :, None] * ps + a["cmap"][:, None, :]
    pools[ps].view(-1).index_add_(0, flat.reshape(-1), sub.reshape(-1),
                                  alpha=-1)


_UPD_ORDER = {"updg": 0, "upda": 1, "upd": 2, "upds": 2}


def _upd_step(pools: Pools, items: list, c: _Consts, batches=whole,
              delta=_upd_delta, apply=_upd_apply) -> None:
    """A step's update keys ((key, a) items, in key order), in JAX's
    order: the "updg" deltas written into the scratch, the "upda"
    applies, then the "upd"/"upds" deltas scatter-subtracted, each kind
    in key order.  Every delta of the step is computed through one
    ``batches`` call (device/batching.py): the GEMMs read only finished
    source panels, which no apply of the step writes.  ``delta`` and
    ``apply`` are the engine's (``_upd_delta`` and ``_upd_apply``
    here)."""
    items = sorted(items, key=lambda it: _UPD_ORDER[it[0][0]])
    gemms = [(key, a) for key, a in items if key[0] != "upda"]
    got = iter(batches([(a["src"].shape[0],
                         lambda lo, hi, key=key, a=a: delta(
                             pools, key, units(a, lo, hi), c))
                        for key, a in gemms]))
    for key, a in items:
        if key[0] == "upda":
            _agg_apply(pools, key, a, c)
        elif key[0] == "updg":
            _agg_write(key, a, *next(got), c)
        else:
            apply(pools, key, a, *next(got))


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


def _each(fn):
    """A phase that runs ``fn(pools, key, a, c)`` on a step's keys in
    turn."""
    def run(pools: Pools, items: list, c: _Consts) -> None:
        for key, a in items:
            fn(pools, key, a, c)
    return run


class _Phases(NamedTuple):
    """A factor's phases for ``_factor``: ``name`` is its caller's span,
    which names the spans of the shared step loop (``<name>.upload``,
    ``<name>.segment``); ``runs`` are (span name, kinds, run), run in
    that order each step (``_segment_factor``)."""
    name: str
    runs: tuple


def _phases(batches=whole, name: str = "superscan.factor") -> _Phases:
    """The factor's phases, the update deltas through ``batches``
    (device/batching.py), their spans named under ``name``."""
    return _Phases(name, (
        (f"{name}.update", ("updg", "upda", "upd", "upds"),
         functools.partial(_upd_step, batches=batches)),
        (f"{name}.chol", ("chol",), _each(_chol)),
        (f"{name}.trsm", ("trsm",), _each(_trsm))))


_FACTOR_PHASES = _phases()


def _segment_factor(seg, xs: Sched, pools: Pools, c: _Consts,
                    phases=_FACTOR_PHASES, fills=None) -> None:
    """One segment's step loop over ``phases.runs`` ((span name, kinds,
    run), run in that order each step; ``run(pools, items, c)`` takes
    the step's non-empty (key, batch) items of its kinds, in key order,
    in its span).  A key's batch is its ladder rung, else its ``fills``
    count (``_fills``), else its capacity.  Steps past ``hi - lo`` are
    the cluster padding of the last chunk, whose indices are all no-ops,
    so they are not run."""
    keys = sorted(xs)
    fills = fills or {}
    with span(f"{phases.name}.segment"):
        for step in range(seg.hi - seg.lo):
            for name, kinds, run in phases.runs:
                items = []
                for key in keys:
                    if key[0] not in kinds:
                        continue
                    arrs = xs[key]
                    lad = seg.ladders.get(key)
                    if lad is not None:
                        bs = lad[int(seg.lvls[key][step])]
                    elif key in fills:
                        bs = int(fills[key][step])
                    else:
                        bs = next(iter(arrs.values())).shape[1]
                    if bs == 0:
                        continue                   # empty rung: no launch
                    items.append((key, {nm: v[step, :bs]
                                        for nm, v in arrs.items()}))
                if items:
                    with span(name):
                        run(pools, items, c)


def _factor(plan: SuperscanPlan, pools: Pools,
            packed: _Packed = None, phases=_FACTOR_PHASES) -> Pools:
    """Factor ``pools`` (the plan's initial pools, on their device) in
    place and return them.  ``packed`` is the plan's factor schedule
    (``_Packed`` of every segment's xs; ``_resolve``'s made here when
    not given), kept resident on the pools' device: the factor that
    finds it on the host uploads it, in a span ``<phases.name>.upload``
    that counts its ``h2d_bytes``, and adds 1 to ``sched_uploads`` of
    the caller's span (0 where the resident schedule serves); ``phases``
    as in ``_segment_factor``."""
    device = next(iter(pools.values())).device
    segs = [seg for seg in plan.segments if seg.xs]
    if packed is None:
        packed = _resolve(plan)[0]
    first = packed.scheds is None
    count("sched_uploads", int(first))
    c = _Consts(device)
    rows = max((seg.scratch_rows for seg in segs), default=0)
    if rows:
        c.scratch = _scratch(rows, device)
    if first:
        with span(f"{phases.name}.upload") as up:
            packed.resident(device)
            if up:
                count("h2d_bytes", packed.nbytes)
    for seg, xs, fills in zip(segs, packed.scheds, packed.fills):
        _segment_factor(seg, xs, pools, c, phases, fills)
    return pools


# ------------------------------------------------------------------- solve
def _diag_solve(pools: Pools, key: tuple, a, xpad: torch.Tensor,
                c: _Consts, transpose: bool) -> None:
    """x[cols] <- Lkk^-1 x[cols] (forward) or Lkk^-T x[cols] (backward)
    on the rows of the (n + 1, k) x; JAX: superscan.py:2015-2027 and
    :2059-2071, vmapped over the k columns."""
    _, pw, W = key
    Lkk = pools[pw][:, :W][a["dbase"][:, None] + c.arange(W)]  # (U,W,W)
    cols = a["cols"]
    xc = xpad[cols]                                        # (U, W, k)
    if transpose:
        y = torch.linalg.solve_triangular(Lkk.mT, xc, upper=True)
    else:
        y = torch.linalg.solve_triangular(Lkk, xc, upper=False)
    xpad.index_copy_(0, cols.reshape(-1), y.reshape(-1, xpad.shape[1]))


def _od_delta(pools: Pools, key: tuple, a, xpad: torch.Tensor,
              c: _Consts, backward: bool) -> tuple:
    """(delta,): the od GEMMs of the trsm slots of ``a`` on the k columns
    (JAX: superscan.py:2028-2042 and :2044-2058), (U, H, k) forward and
    (U, W, k) backward.  Rows whose target is the pad entry n are masked
    out with torch.where."""
    _, pw, H, W = key
    nn = xpad.shape[0] - 1
    mask = (a["tgt"] < nn)[..., None]
    Y = torch.where(mask, pools[pw][:, :W][a["rows"]], c.zero)  # (U,H,W)
    if backward:
        xod = torch.where(mask, xpad[a["tgt"]], c.zero)    # (U, H, k)
        return (torch.bmm(Y.mT, xod),)
    return (torch.bmm(Y, xpad[a["cols"]]),)


def _od_apply(a, xpad: torch.Tensor, delta: torch.Tensor,
              backward: bool) -> None:
    """Scatter-subtracts the od deltas into x: at the slots' columns
    backward, at their targets forward."""
    at = a["cols"] if backward else a["tgt"]
    xpad.index_add_(0, at.reshape(-1), delta.reshape(-1, xpad.shape[1]),
                    alpha=-1)


def _od_solve(pools: Pools, items: list, xpad: torch.Tensor, c: _Consts,
              backward: bool, batches=whole, delta=_od_delta) -> None:
    """The od GEMMs of a step's trsm keys ((key, a) items) over each
    key's batch of slots (``batches``), scatter-subtracted into x in key
    order; ``delta`` is the engine's (``_od_delta`` here)."""
    got = batches([(a["rows"].shape[0],
                    lambda lo, hi, key=key, a=a: delta(
                        pools, key, units(a, lo, hi), xpad, c, backward))
                   for key, a in items])
    for (key, a), (d,) in zip(items, got):
        _od_apply(a, xpad, d, backward)


def _solve_steps(xs: Dict[tuple, Dict[str, np.ndarray]], n: int
                 ) -> List[Dict[tuple, Dict[str, np.ndarray]]]:
    """One segment of ``_solve_xs`` as per-step schedules ({key: {name:
    array}}, keys in sorted order) of the (step, key) pairs that hold a
    real slot, each cut to its fill (``_fill``); steps without one are
    dropped.  A chol slot is real where a ``cols`` entry is below n, a
    trsm slot where a ``cols`` or ``tgt`` entry is.  A padded slot only
    writes row n or adds zeros to it, so the cut leaves each real slot's
    arithmetic as it was (a GEMM library may still round a slot by the
    size of its batch: torch's CPU ``bmm`` takes another path for one)."""
    keys = sorted(xs)
    fills = {}
    for key in keys:
        d = xs[key]
        real = (d["cols"] < n).any(axis=2)
        if key[0] == "trsm":
            real |= (d["tgt"] < n).any(axis=2)
        fills[key] = _fill(real)
    out = []
    for step in range(len(fills[keys[0]])):
        got = {k: {nm: v[step, :fills[k][step]] for nm, v in xs[k].items()}
               for k in keys if fills[k][step]}
        if got:
            out.append(got)
    return out


def _step_solve(xs: Sched, pools, xpad: torch.Tensor, c: _Consts,
                backward: bool, batches=whole, diag=_diag_solve,
                delta=_od_delta) -> None:
    """One step's pairs (``_solve_steps``), forward (diagonal solves,
    then the od GEMMs) or backward (the reverse); the od GEMMs go through
    ``batches`` (device/batching.py).  ``diag`` and ``delta`` are the
    engine's diagonal solve and od GEMMs (``_diag_solve`` and
    ``_od_delta`` here, ``superscan_lu``'s for the LU).  Row n is zeroed
    after the step."""
    ck = [(k, a) for k, a in xs.items() if k[0] == "chol"]
    tk = [(k, a) for k, a in xs.items() if k[0] == "trsm"]
    if not backward:
        for k, a in ck:
            diag(pools, k, a, xpad, c, False)
        _od_solve(pools, tk, xpad, c, False, batches, delta)
    else:
        _od_solve(pools, tk, xpad, c, True, batches, delta)
        for k, a in ck:
            diag(pools, k, a, xpad, c, True)
    xpad[xpad.shape[0] - 1] = 0.0


def _solve_schedule(plan: SuperscanPlan, device) -> List[Sched]:
    """The solve schedule of ``plan`` on ``device``, one entry a step: the
    pairs of ``_solve_xs`` with a real slot, cut to their fill
    (``_solve_steps``), in one uploaded buffer (``_Packed``)."""
    return _Packed([st for xs in _solve_xs(plan) if xs
                    for st in _solve_steps(xs, plan.n)]).upload(device)


def _solve_sweep(F, Bm: np.ndarray, batches, name: str, diag,
                 delta) -> np.ndarray:
    """One f32 sweep of the factored engine ``F`` (its ``plan``,
    ``pools``, ``_sched()``, ``_consts`` and ``device``) on the (n, k)
    right-hand sides at once: forward then backward over the packed
    steps (``_step_solve`` with ``batches``, ``diag`` and ``delta``); the
    factor never leaves the device.  The spans are named under ``name``
    (``<name>.sweep`` around ``<name>.forward`` and ``<name>.backward``),
    and each direction's span counts the ``pairs`` it runs."""
    plan = F.plan
    Bm = np.asarray(Bm, np.float64)
    with span(f"{name}.sweep"):
        xpad = np.zeros((plan.n + 1, Bm.shape[1]), dtype=np.float32)
        xpad[:plan.n] = Bm[plan.perm]
        xpad = torch.from_numpy(xpad).to(F.device)
        sched = F._sched()
        for way, steps in (("forward", sched), ("backward", reversed(sched))):
            with span(f"{name}.{way}") as sp:
                for xs in steps:
                    _step_solve(xs, F.pools, xpad, F._consts,
                                way == "backward", batches, diag, delta)
                if sp:
                    count("pairs", sum(map(len, sched)))
        X = np.zeros((plan.n, Bm.shape[1]))
        X[plan.perm] = xpad[:plan.n].cpu().numpy()
    return X


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
        with span("superscan.plan"):
            self.plan = plan_superscan(A, order=order, wmax=wmax, tau=tau,
                                       small_w=small_w,
                                       max_segments=max_segments)
        self.pools = None
        self._factor_sched: _Packed = None
        self._pool_host: Dict[int, torch.Tensor] = None
        self._solve_sched: List[Sched] = None
        self._consts = _Consts(self.device)
        self._Lhost: CSCMatrix = None
        self._ud_sched = None

    def load_pools(self, pools: Dict[int, np.ndarray]) -> None:
        """Take factored (or initial) pools from the host, e.g. the JAX
        package's ``{pw: np.asarray(v) for pw, v in F.pools.items()}``."""
        self.pools = pools_from_numpy(pools, self.device)
        self._Lhost = None

    def factor(self) -> bool:
        """Factor the plan's initial pools on the device; False where the
        factor is not finite (A not positive definite).  The first call
        resolves and packs the factor schedule (``_resolve``) and counts
        the entries redirected, ``remapped``, on its upload span."""
        plan = self.plan
        remapped = None
        if self._factor_sched is None:
            self._factor_sched, remapped = _resolve(plan)
            self._pool_host = _host_pools(plan.pool_init, self.device)
        with span("superscan.factor"):
            with span("superscan.factor.upload") as up:
                pools = _pools_on(self._pool_host, self.device)
                if up:
                    count("h2d_bytes", sum(v.nbytes for v in pools.values()))
                    if remapped is not None:
                        count("remapped", remapped)
            pools = _factor(plan, pools, self._factor_sched)
            # the one host sync: finiteness over the real rows only (the
            # identity and dump rows below them are not checked)
            with span("superscan.factor.check"):
                ok = bool(torch.stack(
                    [torch.isfinite(v[:plan.pool_rows[pw]]).all()
                     for pw, v in pools.items()]).all())
        if ok:
            self.pools = pools
            self._Lhost = None
        return ok

    def _sched(self) -> List[Sched]:
        """The solve schedule (``_solve_schedule``), built and uploaded
        once, kept on the device."""
        if self._solve_sched is None:
            self._solve_sched = _solve_schedule(self.plan, self.device)
        return self._solve_sched

    def _solve_f32_many(self, Bm: np.ndarray, batches=whole) -> np.ndarray:
        """Forward then backward over the pools on the (n, k) right-hand
        sides at once, in f32 (JAX: the segment solves vmapped over the
        RHS axis, superscan.py:2267-2299), in spans
        ``superscan.solve.*`` (``_solve_sweep``); ``batches`` as in
        ``_step_solve``."""
        return _solve_sweep(self, Bm, batches, "superscan.solve",
                            _diag_solve, _od_delta)

    def _solve_f32(self, b: np.ndarray) -> np.ndarray:
        return self._solve_f32_many(np.asarray(b, np.float64)[:, None])[:, 0]

    def solve(self, b: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        if self.pools is None and not self.factor():
            raise ValueError("matrix is not positive definite")
        solve_f32 = self._solve_f32

        def sweep(r):
            count("sweeps")
            return solve_f32(r)
        with span("superscan.solve"):
            return refine(self.A, sweep, b, iters=refine_iters)

    def solve_many(self, B: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        """Solve A X = B for (n, k) right-hand sides: one batched device
        solve per sweep + batched f64 refinement (factor once, solve
        many).  The span ``superscan.solve_many`` counts the ``sweeps``
        and the ``cols`` k; its sweeps keep the ``superscan.solve.*``
        names."""
        B = np.asarray(B, dtype=np.float64)
        if B.ndim == 1:
            return self.solve(B, refine_iters)
        if self.pools is None and not self.factor():
            raise ValueError("matrix is not positive definite")
        solve_f32_many = self._solve_f32_many

        def sweep(R):
            count("sweeps")
            return solve_f32_many(R)
        with span("superscan.solve_many"):
            count("cols", B.shape[1])
            return refine_many(self.A, sweep, B, refine_iters)

    def solve_host(self, b: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        """Host f64 triangular solves on the extracted factor (downloads
        the pools once; the host copy is kept until the next factor or
        updown)."""
        if self.pools is None and not self.factor():
            raise ValueError("matrix is not positive definite")
        if self._Lhost is None:
            self._Lhost = self.extract_L()

        def f32_solve(rhs):
            xp = lsolve(self._Lhost, pvec(self.plan.perm, rhs))
            return ipvec(self.plan.perm, ltsolve(self._Lhost, xp))

        return refine(self.A, f32_solve, b, iters=refine_iters)

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

    # ------------------------------------------------------------ updown
    def _updown_sched(self):
        """Static per-column schedule of the updown loop over the pools
        concatenated into one flat vector in sorted width order, plus one
        dump entry (JAX: superscan.py:2315-2354): for every column j, the
        flat index of L(j, j) (``dflat``, host: the loop reads it as
        Python ints), and the flat indices of its stored entries below
        the diagonal with their global rows (``colidx``, ``rowid``,
        (n, H), on the device; padding points at the dump entry and the
        dump row n).  Built once per plan."""
        if self._ud_sched is not None:
            return self._ud_sched
        plan = self.plan
        n = plan.n
        pws = sorted(plan.pool_init)
        off, total = {}, 0
        for pw in pws:
            off[pw] = total
            total += plan.pool_init[pw].size
        H = max(max((pl.W - 1 + pl.rows.size for pl in plan.panels),
                    default=1), 1)
        dflat = np.zeros(n, np.int64)
        colidx = np.full((n, H), total, np.int64)
        rowid = np.full((n, H), n, np.int64)
        for pl in plan.panels:
            pw = pl.pool
            for c in range(pl.w):
                j = pl.c0 + c
                base = off[pw] + pl.rbase * pw + c
                dflat[j] = base + c * pw
                q = np.arange(c + 1, pl.W)
                colidx[j, :q.size] = base + q * pw
                rows_d = pl.c0 + q
                rowid[j, :q.size] = np.where(rows_d < pl.c0 + pl.w, rows_d,
                                             n)
                m = pl.rows.size
                colidx[j, q.size:q.size + m] = \
                    base + (pl.W + np.arange(m)) * pw
                rowid[j, q.size:q.size + m] = pl.rows
        self._ud_sched = dict(
            dflat=dflat, colidx=torch.from_numpy(colidx).to(self.device),
            rowid=torch.from_numpy(rowid).to(self.device), H=H,
            total=total, pws=pws, off=off)
        return self._ud_sched

    def updown(self, sigma: int, w: np.ndarray) -> bool:
        """Rank-1 update/downdate of the factored pools: A <- A + sigma*w*w'
        (reference: csparse::cs_updown).

        w is in original coordinates; its pattern must be contained in a
        column pattern of L (the reference demo3 contract).  The
        recurrence runs on the card over the pools concatenated into one
        flat vector (``chol_tpu._updown``); afterwards the pools are views
        into it.  On a failed downdate (not positive definite) the old
        pools are kept and False returned."""
        if self.pools is None:
            raise ValueError("factor() first")
        plan = self.plan
        w = np.asarray(w, dtype=np.float64)
        sched = self._updown_sched()
        poolf = torch.cat([self.pools[pw].reshape(-1) for pw in sched["pws"]]
                          + [self.pools[sched["pws"][0]].new_zeros(1)])
        wt = torch.from_numpy(np.concatenate([w[plan.perm], [0.0]]).astype(
            np.float32)).to(self.device)
        ok = _updown(poolf, wt, sched["dflat"], sched["colidx"],
                     sched["rowid"], 1 if sigma > 0 else -1)
        if not bool(ok):
            return False
        self.pools = {pw: poolf[sched["off"][pw]:sched["off"][pw]
                                + plan.pool_init[pw].size]
                      .view(plan.pool_init[pw].shape)
                      for pw in sched["pws"]}
        self._Lhost = None
        W = csc_from_dense(w.reshape(-1, 1))
        self.A = add(self.A, multiply(W, transpose(W)), 1.0, float(sigma))
        return True

    def metrics(self) -> Metrics:
        plan = self.plan
        m = Metrics().record_plan("chol", plan)
        m.record(chol_engine="superscan",
                 chol_panels=len(plan.panels),
                 chol_steps=int(plan.nsteps),
                 chol_segments=len(plan.segments),
                 chol_levels=int(plan.nlevels),
                 chol_nnz_predicted=int(plan.lnz))
        return m
