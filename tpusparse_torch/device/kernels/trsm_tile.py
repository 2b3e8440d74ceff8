"""Batched triangular solves Y[i] = X[i] @ L^-T with a lower L: per slot
(``trsm_tiles_batched``, the trsm phase of the superscan factorization)
or one L shared by the batch (``trsm_tiles``, the panel trsm of the
fixed-tile engine).

Counterpart of tpusparse/device/kernels/trsm_tile.py (the Pallas
kernels ``_trsm_kernel_b`` and ``_trsm_kernel``).  On a CUDA tensor each
wrapper launches the hand-written kernel of csrc/trsm_tile.cu and adds
one to its own ``launches``; on a CPU tensor it returns its plain
version (``trsm_tiles_batched_ref``, ``trsm_tiles_ref``) and counts
nothing.
"""

from __future__ import annotations

import torch

from . import _build
from ._args import expect, one_device

__all__ = ["trsm_tiles", "trsm_tiles_ref", "trsm_tiles_batched",
           "trsm_tiles_batched_ref"]

_MAX = 128


def _check(fn: str, Lkk: torch.Tensor, X: torch.Tensor,
           shared: bool) -> torch.device:
    expect(fn, "Lkk", Lkk, torch.float32, 2 if shared else 3)
    expect(fn, "X", X, torch.float32, 3)
    nt, R, W = X.shape
    if tuple(Lkk.shape) != ((W, W) if shared else (nt, W, W)):
        raise ValueError(f"{fn}: Lkk {tuple(Lkk.shape)} does not match X "
                         f"{tuple(X.shape)}")
    for name, v in (("R", R), ("W", W)):
        if v % 8 or not 8 <= v <= _MAX:
            raise ValueError(f"{fn}: {name} must be a multiple of 8 in "
                             f"[8, {_MAX}], got {v}")
    return one_device(fn, Lkk, X)


def _launch(entry: str, Lkk: torch.Tensor, X: torch.Tensor,
            dev: torch.device) -> torch.Tensor:
    out = torch.empty_like(X)
    nt, R, W = X.shape
    if nt == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(getattr(lib, entry)(Lkk.data_ptr(), X.data_ptr(),
                                     out.data_ptr(), nt, R, W, stream),
                 entry)
    return out


def trsm_tiles_ref(Lkk: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain version: solves Y @ Lkk^T = X for Y against the broadcast
    Lkk."""
    return torch.linalg.solve_triangular(Lkk.mT.expand(X.shape[0], -1, -1),
                                         X, upper=True, left=False)


def trsm_tiles(Lkk: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y[i] = X[i] @ Lkk^-T for one Lkk (W, W) lower and X (nt, R, W),
    f32.  Only the lower triangle of Lkk is read."""
    dev = _check("trsm_tiles", Lkk, X, shared=True)
    if dev.type == "cpu":
        return trsm_tiles_ref(Lkk, X)
    out = _launch("tpt_trsm_tiles", Lkk, X, dev)
    if X.shape[0]:
        trsm_tiles.launches += 1
    return out


trsm_tiles.launches = 0


def trsm_tiles_batched_ref(Lkk: torch.Tensor, X: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version: solves Y @ Lkk^T = X for Y."""
    return torch.linalg.solve_triangular(Lkk.mT, X, upper=True,
                                         left=False)


def trsm_tiles_batched(Lkk: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y[i] = X[i] @ Lkk[i]^-T for Lkk (nt, W, W) lower and X (nt, R, W),
    f32.  Only the lower triangle of Lkk is read."""
    dev = _check("trsm_tiles_batched", Lkk, X, shared=False)
    if dev.type == "cpu":
        return trsm_tiles_batched_ref(Lkk, X)
    out = _launch("tpt_trsm_tiles_batched", Lkk, X, dev)
    if X.shape[0]:
        trsm_tiles_batched.launches += 1
    return out


trsm_tiles_batched.launches = 0
