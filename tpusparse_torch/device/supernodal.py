"""Variable-width supernodal Cholesky in PyTorch: factor and solve.

Port of the device half of tpusparse/device/supernodal.py.  The plan is
the JAX package's, made by the numpy planner copied into
``supernodal_plan``: panels of width W (a power of two <= 128) with R
rows, pooled per bucket (R, W) as (cnt, R, W) tensors, and a level
schedule over the supernode etree.  Its schedules are packed as
superscan's (``_Packed``): the factor schedule uploaded once per
``factor()``, the solve schedule once per object, int64 on the
factor's device.  The pools are updated in place (``index_add_``,
``index_copy_``) where JAX rebuilt them functionally.

Factor: a host loop over the levels (JAX: ``_factor_fn``, unrolled under
one jit).  Per level, first every update group (descendant bucket,
target bucket): masked row gathers of the factored descendant panels,
one ``bmm`` for the L1 @ L0^T blocks and an ``index_add_`` into the
target slots (a slot may repeat within a group); then per bucket the
panels of the level: batched Cholesky of the W x W diagonal blocks, a
batched triangular solve of the rows below them, written back with
``index_copy_``.  JAX computes all of this outside Pallas
(``jnp.linalg.cholesky``, ``lax.linalg.triangular_solve``, ``einsum``),
so the port uses the library calls ``cholesky_ex``, ``solve_triangular``
and ``bmm``; a block whose Cholesky fails is set to NaN (the NaN
contract of ``jnp.linalg.cholesky``), and the one host sync is the
finiteness check of the pools at the end.  The gather row indices of
the update groups (descendant slot, panel offset and clamped
G1/G0 position) are summed on the host before the upload.

Solve: forward per level (diagonal solves, then the GEMVs of the rows
below them scatter-subtracted into a padded x of length n + 1 whose
dump entry n is zeroed after each), backward in reverse, in f32 for all
k right-hand sides at once as an (n + 1, k) tensor; then host f64
iterative refinement.

``metrics()`` waits for a port of utils/profiling.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.matrix import CSCMatrix

from .config import DTYPE
from .refine import refine
from .refine_many import refine_many
from .superscan import _Consts, _Packed
from .supernodal_plan import SupernodalPlan, plan_supernodal

__all__ = ["SupernodalCholesky", "SupernodalPlan", "plan_supernodal",
           "pools_from_numpy", "pools_to_numpy"]

Bucket = Tuple[int, int]
Pools = Dict[Bucket, torch.Tensor]


def pools_from_numpy(pools: Dict[Bucket, np.ndarray], device) -> Pools:
    """Copy host pools ({bucket (R, W): (cnt, R, W) array}) to ``device``
    as f32 tensors; never shares memory with the arrays."""
    return {(int(b[0]), int(b[1])): torch.tensor(np.asarray(v), dtype=DTYPE,
                                                 device=device)
            for b, v in pools.items()}


def pools_to_numpy(pools: Pools) -> Dict[Bucket, np.ndarray]:
    return {b: v.detach().cpu().numpy() for b, v in pools.items()}


def _factor_xs(plan: SupernodalPlan) -> List[dict]:
    """Per level, in JAX's order: ("upd", d bucket, s bucket) -> target
    slots ``ssl``, gather rows ``r1`` (P, Rs) and ``r0`` (P, Ws) into the
    flat (cnt * Rd, Wd) descendant pool with their -1 padded positions
    ``g1``/``g0`` (the masks); then ("fac", bucket) -> ``slots``."""
    out = []
    for lvl in range(plan.nlevels):
        xs = {}
        for (db, sb), (ssl, G1, G0, dsl) in plan.level_updates[lvl].items():
            base = dsl[:, None] * db[0] + db[1]          # od rows start
            xs[("upd", db, sb)] = dict(
                ssl=ssl, r1=base + np.maximum(G1, 0), g1=G1,
                r0=base + np.maximum(G0, 0), g0=G0)
        for b, slots in plan.level_factor[lvl].items():
            xs[("fac", b)] = dict(slots=slots)
        out.append(xs)
    return out


def _solve_xs(plan: SupernodalPlan) -> List[dict]:
    """Per level: bucket -> ``slots`` of its panels at that level in slot
    order, their columns ``cols`` (cnt, W) and the rows below their
    diagonal blocks ``odr`` (cnt, R - W), padded with the dump row n
    (JAX: the ``fwd_sched`` of ``_solve_fn``, supernodal.py:383-400)."""
    n = plan.n
    groups = defaultdict(list)
    for s in plan.snodes:
        groups[(s.level, s.bucket)].append(s)
    out = []
    for lvl in range(plan.nlevels):
        xs = {}
        for b in plan.level_factor[lvl]:
            R, W = b
            sns = sorted(groups[(lvl, b)], key=lambda s: s.slot)
            odr = np.full((len(sns), R - W), n, np.int64)
            for i, s in enumerate(sns):
                odr[i, :s.rows.size] = s.rows
            xs[b] = dict(slots=np.asarray([s.slot for s in sns], np.int64),
                         cols=np.stack([np.arange(s.c0, s.c0 + W)
                                        for s in sns]),
                         odr=odr)
        out.append(xs)
    return out


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a batch, NaN where one fails (where
    ``jnp.linalg.cholesky`` returns NaN and ``torch.linalg.cholesky``
    would raise)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[:, None, None], float("nan"), L)


# ------------------------------------------------------------------ factor
def _update(pools: Pools, db: Bucket, sb: Bucket, a, c: _Consts) -> None:
    """delta = L1 @ L0^T from the factored descendant panels, subtracted
    from the target slots (JAX: supernodal.py:337-351).  Padded
    positions gather a clamped row under a false mask."""
    flat = pools[db].view(-1, db[1])                     # (cnt * Rd, Wd)
    L1 = torch.where((a["g1"] >= 0)[..., None], flat[a["r1"]], c.zero)
    L0 = torch.where((a["g0"] >= 0)[..., None], flat[a["r0"]], c.zero)
    pools[sb].index_add_(0, a["ssl"], torch.bmm(L1, L0.mT), alpha=-1)


def _panels(pools: Pools, b: Bucket, slots: torch.Tensor) -> None:
    """Factor the level's panels of bucket b (JAX: supernodal.py:353-368).
    The diagonal blocks started lower-only and took updates in both
    triangles, so the lower triangle is mirrored first, as JAX does."""
    R, W = b
    P = pools[b][slots]                                  # (cnt, R, W)
    top = P[:, :W]
    Lkk = _cholesky(torch.tril(top) + torch.tril(top, -1).mT)
    if R > W:
        Y = torch.linalg.solve_triangular(Lkk.mT, P[:, W:], upper=True,
                                          left=False)
        Lkk = torch.cat([Lkk, Y], dim=1)
    pools[b].index_copy_(0, slots, Lkk)


def _factor(pools: Pools, xs_levels: List[dict], c: _Consts) -> Pools:
    """Factor ``pools`` (the plan's initial pools, on their device) in
    place by the uploaded level schedule and return them."""
    for xs in xs_levels:
        for key, a in xs.items():
            if key[0] == "upd":
                _update(pools, key[1], key[2], a, c)
            else:
                _panels(pools, key[1], a["slots"])
    return pools


# ------------------------------------------------------------------- solve
def _solve(pools: Pools, xs_levels: List[dict], xpad: torch.Tensor
           ) -> torch.Tensor:
    """L L' X = B on the factored pools, in place on ``xpad`` (n + 1, k)
    in permuted coordinates (JAX: supernodal.py:402-433, vmapped over
    the k columns)."""
    n, k = xpad.shape[0] - 1, xpad.shape[1]
    for xs in xs_levels:
        for (R, W), a in xs.items():
            P = pools[(R, W)][a["slots"]]
            cols = a["cols"].reshape(-1)
            xc = xpad[cols].view(-1, W, k)
            yc = torch.linalg.solve_triangular(P[:, :W], xc, upper=False)
            xpad.index_copy_(0, cols, yc.reshape(-1, k))
            if R > W:
                delta = torch.bmm(P[:, W:], yc)          # (cnt, R - W, k)
                xpad.index_add_(0, a["odr"].reshape(-1),
                                delta.reshape(-1, k), alpha=-1)
                xpad[n] = 0.0
    for xs in reversed(xs_levels):
        for (R, W), a in xs.items():
            P = pools[(R, W)][a["slots"]]
            cols = a["cols"].reshape(-1)
            acc = xpad[cols].view(-1, W, k)
            if R > W:
                xod = xpad[a["odr"].reshape(-1)].view(-1, R - W, k)
                acc = acc - torch.bmm(P[:, W:].mT, xod)
            xc = torch.linalg.solve_triangular(P[:, :W].mT, acc, upper=True)
            xpad.index_copy_(0, cols, xc.reshape(-1, k))
    return xpad


class SupernodalCholesky:
    """Plan, factor and solve of the variable-panel supernodal
    engine (same contracts as the JAX ``SupernodalCholesky``): f32
    factor on ``device``, f64 refined solves.

    ``device`` defaults to "cuda", so a machine without a card fails here
    instead of running on the CPU."""

    def __init__(self, A: CSCMatrix, order: int = 1, wmax: int = 128,
                 tau: float = 0.1, small_w: int = 128, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SupernodalCholesky: device 'cuda' requested "
                               "but torch.cuda.is_available() is False")
        self.A = A
        self.plan = plan_supernodal(A, order=order, wmax=wmax, tau=tau,
                                    small_w=small_w)
        self.pools: Optional[Pools] = None
        self._factor_sched = _Packed(_factor_xs(self.plan))
        self._solve_sched: Optional[List[dict]] = None
        self._consts = _Consts(self.device)

    def load_pools(self, pools: Dict[Bucket, np.ndarray]) -> None:
        """Take factored (or initial) pools from the host, e.g. the JAX
        package's ``{b: np.asarray(v) for b, v in F.pools.items()}``."""
        self.pools = pools_from_numpy(pools, self.device)

    def factor(self) -> bool:
        pools = _factor(pools_from_numpy(self.plan.pool_init, self.device),
                        self._factor_sched.upload(self.device), self._consts)
        ok = bool(torch.stack([torch.isfinite(v).all()
                               for v in pools.values()]).all())
        if ok:
            self.pools = pools
        return ok

    def _solve_f32_many(self, Bm: np.ndarray) -> np.ndarray:
        plan = self.plan
        if self._solve_sched is None:
            self._solve_sched = _Packed(_solve_xs(plan)).upload(self.device)
        xpad = np.zeros((plan.n + 1, Bm.shape[1]), dtype=np.float32)
        xpad[:plan.n] = Bm[plan.perm]
        out = _solve(self.pools, self._solve_sched,
                     torch.from_numpy(xpad).to(self.device))
        X = np.zeros((plan.n, Bm.shape[1]))
        X[plan.perm] = out[:plan.n].cpu().numpy()
        return X

    def _solve_f32(self, b: np.ndarray) -> np.ndarray:
        return self._solve_f32_many(np.asarray(b, np.float64)[:, None])[:, 0]

    def solve(self, b: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        if self.pools is None and not self.factor():
            raise ValueError("matrix is not positive definite")
        return refine(self.A, self._solve_f32, b, iters=refine_iters)

    def solve_many(self, B: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        """Solve A X = B for (n, k) right-hand sides: batched device
        solves + batched f64 refinement (factor once, solve many)."""
        B = np.asarray(B, dtype=np.float64)
        if B.ndim == 1:
            return self.solve(B, refine_iters)
        if self.pools is None and not self.factor():
            raise ValueError("matrix is not positive definite")
        return refine_many(self.A, self._solve_f32_many, B, refine_iters)
