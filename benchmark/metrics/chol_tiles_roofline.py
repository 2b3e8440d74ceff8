"""chol_tiles_roofline: B1 (``csrc/chol_tile.cu``) against its roofline
(``_roofline.chol_tiles_counts``), in %."""

from benchmark.metrics import _kernel_roofline, _roofline


def read(tr):
    return _kernel_roofline.share(tr, "chol_tiles", "chol_tile_kernel",
                                  _roofline.chol_tiles_counts)
