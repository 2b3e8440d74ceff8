"""trsm_tiles_roofline: B2 (``csrc/trsm_tile.cu``, launched through
``trsm_tiles_batched``) against its roofline
(``_roofline.trsm_tiles_batched_counts``), in %."""

from benchmark.metrics import _kernel_roofline, _roofline


def read(tr):
    return _kernel_roofline.share(tr, "trsm_tiles_batched",
                                  "trsm_tile_kernel",
                                  _roofline.trsm_tiles_batched_counts)
