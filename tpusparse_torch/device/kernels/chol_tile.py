"""Batched lower Cholesky of (nt, B, B) tiles: the chol phase of the
superscan factorization and the panel factor of the fixed-tile engine.

Counterpart of tpusparse/device/kernels/chol_tile.py (the Pallas kernel
``_chol_tile_kernel``).  On a CUDA tensor ``chol_tiles`` launches the
hand-written kernel of csrc/chol_tile.cu and adds one to
``chol_tiles.launches``; on a CPU tensor it returns the plain version
``chol_tiles_ref`` and counts nothing.  Failure contract, as in the JAX
package: a tile that is not positive definite comes out non-finite.
"""

from __future__ import annotations

import torch

from . import _build
from ._args import expect, one_device

__all__ = ["chol_tiles", "chol_tiles_ref"]

_MAX_B = 128


def _check(tiles: torch.Tensor) -> torch.device:
    expect("chol_tiles", "tiles", tiles, torch.float32, 3)
    if tiles.shape[1] != tiles.shape[2]:
        raise ValueError(f"chol_tiles: (nt, B, B) expected, got "
                         f"{tuple(tiles.shape)}")
    B = tiles.shape[1]
    if B % 8 or not 8 <= B <= _MAX_B:
        raise ValueError(f"chol_tiles: B must be a multiple of 8 in "
                         f"[8, {_MAX_B}], got {B}")
    return one_device("chol_tiles", tiles)


def chol_tiles_ref(tiles: torch.Tensor) -> torch.Tensor:
    """Plain version: ``cholesky_ex``, every tile whose factorization
    failed set to NaN (``torch.linalg.cholesky`` would raise, where
    ``jnp.linalg.cholesky`` returns NaN), then the lower triangle."""
    L, info = torch.linalg.cholesky_ex(tiles)
    return torch.tril(torch.where((info != 0)[:, None, None],
                                  float("nan"), L))


def chol_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of the (nt, B, B) f32 SPD tiles; zeros above
    the diagonal.  Only the lower triangle of the input is read."""
    dev = _check(tiles)
    if dev.type == "cpu":
        return chol_tiles_ref(tiles)
    out = torch.empty_like(tiles)
    nt, B, _ = tiles.shape
    if nt == 0:
        return out
    if tiles.data_ptr() % 16:       # the kernel reads 16 bytes at a time
        tiles = tiles.clone()
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.tpt_chol_tiles(tiles.data_ptr(), out.data_ptr(), nt,
                                    B, stream), "tpt_chol_tiles")
    chol_tiles.launches += 1
    return out


chol_tiles.launches = 0
