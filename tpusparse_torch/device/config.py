"""Device configuration of the PyTorch port: working dtype, f32
precision pins and tile sizes (counterpart of
tpusparse/device/config.py).

The JAX package runs every einsum at ``Precision.HIGHEST`` because the
default matmul precision of its device rounds to bf16.  The same trap
exists on the card as TF32, so it is switched off here, once, for
cuBLAS and cuDNN alike.  There is no switch that selects a kernel: the
kernel wrappers dispatch on the device of the tensor they are given.
"""

from __future__ import annotations

import os

import torch

__all__ = ["DTYPE", "IDX_DTYPE", "default_block", "cdiv", "round_up"]

DTYPE = torch.float32
IDX_DTYPE = torch.int64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_block() -> int:
    """Tile edge of the fixed-tile engine: TPUSPARSE_BLOCK, default 128
    (the largest tile the chol and trsm kernels take)."""
    return int(os.environ.get("TPUSPARSE_BLOCK", "128"))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m
