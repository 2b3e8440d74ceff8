"""SpMV traffic: a Krylov-style chain of device products y = A x with the
carry x <- y / ||A||_inf, by one caller, on the plan of
``spmv_plan(A, mode)``.

The carry neither overflows nor vanishes over a window (the spectral
radius of A / ||A||_inf is just under 1), and it chains the applies as
a Krylov loop does.  The host does not wait on an apply; the window
ends with a device sync.  The chain cannot be redone after the window,
so a sample of its applies is judged: the inputs and outputs of
``sample`` applies drawn from the seed by reservoir sampling (Vitter's
algorithm L), copied as they come into pinned host buffers made in
set-up, so that the sample holds no device memory, and of the last one;
each y is compared with the float64 A x (``reference.spmv``).  The
control puts the TF32 reference (``reference.spmv.Tf32Spmv``) in the
program's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import csc, spmv


class _Reservoir:
    """A uniform sample of k slots of a stream of unknown length; the
    skips are drawn from ``rng`` (Vitter's algorithm L), so an item
    costs one comparison.  ``offer`` returns the slot the item takes,
    or None."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.i = k, rng, 0
        self.w = math.exp(math.log(rng.random()) / k)
        self.next = k + self._skip()

    def _skip(self) -> int:
        return int(math.log(self.rng.random()) / math.log(1.0 - self.w))

    def offer(self):
        i, self.i = self.i, self.i + 1
        if i < self.k:
            return i
        if i == self.next:
            self.w *= math.exp(math.log(self.rng.random()) / self.k)
            self.next += 1 + self._skip()
            return int(self.rng.integers(self.k))
        return None


def setup(ctx) -> dict:
    from tpusparse_torch.core.matrix import CSCMatrix
    from tpusparse_torch.device.spmv import spmv_plan
    m, n = ctx.A[0], ctx.A[1]
    ctx.facts.update(m=m, n=n, nnz=int(ctx.A[2][-1]))
    plan = ctx.cached("spmv_plan", lambda: spmv_plan(
        CSCMatrix(*ctx.A), ctx.traffic["mode"], device=str(ctx.device)))
    apply = (spmv.Tf32Spmv(ctx.A, ctx.device).apply if ctx.control
             else plan.apply)
    pin = ctx.device.type == "cuda"
    k = ctx.traffic["sample"]
    slots = [(torch.empty(n, dtype=torch.float32, pin_memory=pin),
              torch.empty(m, dtype=torch.float32, pin_memory=pin))
             for _ in range(k)]
    x = torch.rand(n, generator=ctx.torch_generator(), device=ctx.device,
                   dtype=torch.float32) * 2 - 1
    scale = 1.0 / csc.norm_inf(ctx.A)
    for _ in range(ctx.traffic["warm_requests"]):
        x = apply(x) * scale
    return {"plan": plan, "apply": apply, "x": x, "scale": scale,
            "sample": _Reservoir(k, ctx.rng(3)), "slots": slots,
            "taken": set(), "last": None}


def request(ctx, st: dict) -> bool:
    x = st["x"]
    with ctx.span("spmv.apply"):
        y = st["apply"](x)
        st["x"] = y * st["scale"]
    slot = st["sample"].offer()
    if slot is not None:
        hx, hy = st["slots"][slot]
        hx.copy_(x, non_blocking=True)
        hy.copy_(y, non_blocking=True)
        st["taken"].add(slot)
    st["last"] = (x, y)
    return True


def finish(ctx, st: dict) -> None:
    ctx.sync()


def collect(ctx, st: dict) -> list:
    pairs = [st["slots"][i] for i in sorted(st["taken"])] + [st["last"]]
    return [(x.double().cpu().numpy(), y.double().cpu().numpy())
            for x, y in pairs]


def check(ctx, pairs: list) -> dict:
    return {"spmv_error": max(spmv.rel_error(ctx.A, x, y)
                              for x, y in pairs)}
