"""QR factor traffic: sparse Householder QR factorizations of one
least-squares pattern, back to back, by one caller, through
``tpusparse_torch``'s ``MultifrontalQR`` (the engine of ``qrsol`` for
problems above 2^22 entries dense).

Set-up builds the ``MultifrontalQR`` (the host plan, at the
configuration's ``order``) and runs the warm factor, which uploads the
scattered A and the schedule; each request is one ``factor()`` on the
held plan, and reads as failed where it returns False (R rank
deficient or not finite).  After the window the R that the last request
left (``extract_R``, in the permuted column order ``plan.q``) is judged
against A (``reference.qr``).  A request that skips its work would leave
that R right, so each request's H2 launches, read from the program's
own counter (``kernels.qr_panel.launches``), are held to the warm
factor's: ``launch_gap`` is the largest difference, and its limit is 0.
The control runs the same with TF32 on.

The harness records a launch's shape from the wrapper's last argument,
which for ``qr_panel(M, taus, k0, pb)`` is the int ``pb``; so in a
traced run this op wraps ``dense.qr_panel`` itself (the name
``qr_factor_partial`` calls) and records (P, m - k0, pb) of each H2
launch made while ``ctx.recording``, for ``qr_panel_roofline``.  The
wrapper is taken off after the window.  A program whose
``MultifrontalQR`` has no ``extract_R`` cannot be judged: set-up
refuses it before it plans.
"""

from __future__ import annotations

import functools

import numpy as np

import tpusparse_torch.device.dense as dense
import tpusparse_torch.device.kernels as kernels
from tpusparse_torch.core.matrix import CSCMatrix
from tpusparse_torch.device.mfqr import MultifrontalQR

from benchmark.reference import qr


def build(ctx):
    """The ``MultifrontalQR`` of A; its construction is the host plan."""
    return ctx.build_solver(lambda: MultifrontalQR(
        CSCMatrix(*ctx.A), order=ctx.config["solver"]["order"],
        device=ctx.device))


def _factor(F) -> tuple:
    """One factor(): (its result, the H2 launches it made)."""
    n0 = kernels.qr_panel.launches
    ok = bool(F.factor())
    return ok, kernels.qr_panel.launches - n0


def _unwrapped():
    fn = dense.qr_panel
    return getattr(fn, "__wrapped__", fn)


def _record_h2(ctx) -> None:
    """Wraps ``dense.qr_panel`` (once: a wrapper left by an earlier run
    of the process is replaced) so that a launch made while
    ``ctx.recording`` keeps (P, m - k0, pb)."""
    fn = _unwrapped()
    shapes = ctx.launches.setdefault("qr_panel", [])

    @functools.wraps(fn)
    def wrapped(M, taus, k0, pb):
        if ctx.recording and M.shape[0]:
            shapes.append((int(M.shape[0]), int(M.shape[1]) - int(k0),
                           int(pb)))
        return fn(M, taus, k0, pb)
    dense.qr_panel = wrapped


def setup(ctx) -> dict:
    if not hasattr(MultifrontalQR, "extract_R"):
        raise RuntimeError("this program's MultifrontalQR has no "
                           "extract_R: its R cannot be judged")
    if ctx.control:
        ctx.enable_tf32()
    if ctx.trace:
        _record_h2(ctx)
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
    """``factor()`` ends in a host sync of its own (the rank check)."""


def collect(ctx, st: dict) -> tuple:
    """(q, R as a CSC tuple) of the held factor, with A(:, q) = Q R, and
    the launch gap."""
    dense.qr_panel = _unwrapped()
    F = st["F"]
    R = F.extract_R()
    return (np.asarray(F.plan.q, np.int64),
            (R.m, R.n, R.indptr, R.indices, R.data), st["gap"])


def check(ctx, out: tuple) -> dict:
    q, R, gap = out
    return {"backward_error": qr.backward_error(
        ctx.A, q, R, ctx.rng(2), ctx.traffic["probes"]),
        "launch_gap": float(gap)}
