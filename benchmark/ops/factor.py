"""Factor traffic: numeric factorizations of one planned pattern, back to
back, by one caller, on ``tpusparse_torch``'s superscan Cholesky (the
engine that ``cholsol`` "auto" picks for n >= 16,384).

Set-up plans the pattern and runs the warm factors; each request is one
``factor()``.  The port has no entry that loads new values into a held
plan, so every request factors the planned values again and its work is
set by the pattern alone.  After the window the factor that the last
request left is judged against A (``reference.cholesky``).  A request
that skips its work would leave that factor right, so each request's
launches of the tile kernels, read from the program's own counters
(``kernels.chol_tiles.launches``, ``kernels.trsm_tiles_batched
.launches``), are held to the warm factor's: ``launch_gap`` is the
largest difference, and its limit is 0.  The control runs the same with
TF32 on.
"""

from __future__ import annotations

import numpy as np

import tpusparse_torch.device.kernels as kernels
import tpusparse_torch.device.superscan as engine
from tpusparse_torch.core.matrix import CSCMatrix

from benchmark.reference import cholesky

# the kernel wrappers the engine launches, as (module, attribute), for
# the launch shapes of the roofline readers
KERNEL_SITES = ((engine, "chol_tiles"), (engine, "trsm_tiles_batched"))


def build(ctx):
    """The superscan Cholesky of A; its construction is the host plan."""
    return ctx.build_solver(lambda: engine.SuperscanCholesky(
        CSCMatrix(*ctx.A), order=ctx.config["solver"]["order"],
        device=ctx.device))


def launches() -> int:
    """The program's count of tile-kernel launches so far."""
    return kernels.chol_tiles.launches + kernels.trsm_tiles_batched.launches


def _factor(F) -> tuple:
    """One factor(): (its result, the tile-kernel launches it made)."""
    n0 = launches()
    ok = bool(F.factor())
    return ok, launches() - n0


def setup(ctx) -> dict:
    if ctx.control:
        ctx.enable_tf32()
    F = build(ctx)
    st = {"F": F, "want": None, "gap": 0}
    for _ in range(ctx.traffic["warm_requests"]):
        ok, st["want"] = _factor(F)
        if not ok:
            raise RuntimeError("the warm factor failed")
    return st


def request(ctx, st: dict) -> bool:
    with ctx.span("factor"):
        ok, n = _factor(st["F"])
    st["gap"] = max(st["gap"], abs(n - st["want"]))
    return ok


def finish(ctx, st: dict) -> None:
    """``factor()`` ends in a host sync of its own."""


def collect(ctx, st: dict) -> tuple:
    """(perm, L as a CSC tuple) of the held factor, every column of the
    pools in permuted coordinates, and the launch gap."""
    F = st["F"]
    L = F.extract_L()
    return (np.asarray(F.plan.perm, np.int64),
            (L.m, L.n, L.indptr, L.indices, L.data), st["gap"])


def check(ctx, out: tuple) -> dict:
    perm, L, gap = out
    return {"backward_error": cholesky.backward_error(
        ctx.A, perm, L, ctx.rng(2), ctx.traffic["probes"]),
        "launch_gap": float(gap)}
