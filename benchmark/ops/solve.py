"""Solve traffic: factor once, then refined solves with a fresh right-hand
side drawn from the seed for each request, by one caller, on the
superscan Cholesky of ``ops.factor``.

Set-up plans, factors and runs the warm solves (the first uploads the
solve schedule).  A wrapper around the instance's f32 device sweep
(``SuperscanCholesky._solve_f32``, which ``solve`` calls once and then
once per refinement step) keeps each request's first sweep.  After the
window each returned x is judged by the residual grade the configuration
states, and each request's first sweep by the same grade
(``reference.solve``).  Where the wrapper kept no sweep (the program no
longer calls that method), the first sweep is read through the public
entry instead: ``solve(b, refine_iters=0)`` on the held factor, for a
few of the window's right-hand sides drawn from the seed.  The control
runs the same with TF32 on.
"""

from __future__ import annotations

import functools
import sys

from benchmark.ops import factor
from benchmark.reference import csc, solve

FALLBACK_SWEEPS = 3     # first sweeps read after the window, if need be


def setup(ctx) -> dict:
    if ctx.control:
        ctx.enable_tf32()
    F = factor.build(ctx)
    if not F.factor():
        raise RuntimeError("the factor failed")
    st = {"F": F, "rng": ctx.rng(1), "done": [], "first": None,
          "sweeps": 0}
    sweep = getattr(type(F), "_solve_f32", None)
    if sweep is not None:
        sweep = functools.partial(sweep, F)

        def traced(b):
            with ctx.span("solve.sweep"):
                x = sweep(b)
            if st["first"] is None:
                st["first"] = x
            st["sweeps"] += 1
            return x
        F._solve_f32 = traced
    for _ in range(ctx.traffic["warm_requests"]):
        _solve(ctx, st)
    st["done"].clear()
    return st


def _solve(ctx, st: dict) -> None:
    b = st["rng"].uniform(-1.0, 1.0, ctx.A[1])
    st["first"], st["sweeps"] = None, 0
    with ctx.span("refine"):
        x = st["F"].solve(b)
    st["done"].append((b, x, st["first"], st["sweeps"]))


def request(ctx, st: dict) -> bool:
    _solve(ctx, st)
    return True


def finish(ctx, st: dict) -> None:
    """``solve`` returns host arrays: nothing is left on the device."""


def collect(ctx, st: dict) -> list:
    done = st["done"]
    print("device sweeps per solve: "
          + " ".join(str(d[3]) for d in done), file=sys.stderr)
    if done and all(d[2] is None for d in done):
        pick = ctx.rng(3).choice(len(done), min(FALLBACK_SWEEPS, len(done)),
                                 replace=False)
        print(f"no sweep kept by the wrapper: first sweeps of requests "
              f"{sorted(pick.tolist())} read by solve(b, refine_iters=0)",
              file=sys.stderr)
        for i in pick:
            b, x, _, n = done[i]
            done[i] = (b, x, st["F"].solve(b, refine_iters=0), n)
    return done


def check(ctx, done: list) -> dict:
    nrm1 = csc.norm_1(ctx.A)
    return {"grade": max(solve.grade(ctx.A, x, b, nrm1) for b, x, _, _ in done),
            "sweep_grade": max(solve.grade(ctx.A, x0, b, nrm1)
                               for b, _, x0, _ in done if x0 is not None)}
