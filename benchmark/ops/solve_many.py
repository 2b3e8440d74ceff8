"""Block solve traffic: factor once, then refined solves of k right-hand
sides at a time, a fresh block drawn from the seed for each request, by
one caller, on the superscan Cholesky of ``ops.factor``.

Set-up plans, factors and runs the warm block solves (the first uploads
the solve schedule).  A request draws B (n x ``k``), entries U(-1, 1)
from the seed's stream 1, and scales column j by 10^u_j with u_j drawn
from U(-``scale_exp``, ``scale_exp``) for that request: load cases of
different magnitude.  Then it runs one ``solve_many(B, refine_iters)``.
A wrapper around the instance's f32 device sweep
(``SuperscanCholesky._solve_f32_many``, which ``solve_many`` calls once
and then once per refinement step) keeps each request's first sweep.
After the window every column of each returned X is judged by the
residual grade the configuration states, and every column of each first
sweep by the same grade (``reference.solve_many``).  Where the wrapper
kept no sweep (the program no longer calls that method), the first sweep
is read through the public entry instead: ``solve_many(B,
refine_iters=0)`` on the held factor, for a few of the window's blocks
drawn from the seed.  The control runs the same with TF32 on.
"""

from __future__ import annotations

import functools
import sys

import numpy as np

from benchmark.ops import factor
from benchmark.reference import csc, solve_many

FALLBACK_SWEEPS = 3     # first sweeps read after the window, if need be


def setup(ctx) -> dict:
    if ctx.control:
        ctx.enable_tf32()
    F = factor.build(ctx)
    if not F.factor():
        raise RuntimeError("the factor failed")
    k = int(ctx.traffic["k"])
    ctx.facts.update(n=ctx.A[1], k=k, lnz=int(F.plan.lnz))
    st = {"F": F, "rng": ctx.rng(1), "done": [], "first": None,
          "sweeps": 0}
    sweep = getattr(type(F), "_solve_f32_many", None)
    if sweep is not None:
        sweep = functools.partial(sweep, F)

        def traced(B):
            x = sweep(B)
            if st["first"] is None:
                st["first"] = x
            st["sweeps"] += 1
            return x
        F._solve_f32_many = traced
    for _ in range(ctx.traffic["warm_requests"]):
        _solve(ctx, st)
    st["done"].clear()
    return st


def _block(ctx, rng: np.random.Generator) -> np.ndarray:
    """B for one request: U(-1, 1) entries, column j times 10^u_j."""
    k, e = int(ctx.traffic["k"]), float(ctx.traffic["scale_exp"])
    B = rng.uniform(-1.0, 1.0, (ctx.A[1], k))
    B *= 10.0 ** rng.uniform(-e, e, k)
    return B


def _solve(ctx, st: dict) -> None:
    B = _block(ctx, st["rng"])
    st["first"], st["sweeps"] = None, 0
    X = st["F"].solve_many(B, refine_iters=ctx.traffic["refine_iters"])
    st["done"].append((B, X, st["first"], st["sweeps"]))


def request(ctx, st: dict) -> bool:
    _solve(ctx, st)
    return True


def finish(ctx, st: dict) -> None:
    """``solve_many`` returns host arrays: nothing is left on the
    device."""


def collect(ctx, st: dict) -> list:
    done = st["done"]
    print("device sweeps per block solve: "
          + " ".join(str(d[3]) for d in done), file=sys.stderr)
    if done and all(d[2] is None for d in done):
        pick = ctx.rng(3).choice(len(done), min(FALLBACK_SWEEPS, len(done)),
                                 replace=False)
        print(f"no sweep kept by the wrapper: first sweeps of requests "
              f"{sorted(pick.tolist())} read by solve_many(B, "
              f"refine_iters=0)", file=sys.stderr)
        for i in pick:
            B, X, _, n = done[i]
            done[i] = (B, X, st["F"].solve_many(B, refine_iters=0), n)
    return done


def check(ctx, done: list) -> dict:
    nrm1 = csc.norm_1(ctx.A)
    return {"grade": max(solve_many.grade(ctx.A, X, B, nrm1)
                         for B, X, _, _ in done),
            "sweep_grade": max(solve_many.grade(ctx.A, X0, B, nrm1)
                               for B, _, X0, _ in done if X0 is not None)}
