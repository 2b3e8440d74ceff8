"""qr_panel_roofline: H2 (``csrc/qr_panel.cu``: ``qr_panel_warp_kernel``,
``qr_panel_block_kernel`` or ``qr_panel_gmem_kernel``, launched through
``dense.qr_panel``) against its roofline
(``_qr_roofline.qr_panel_counts``), in %."""

from benchmark.metrics import _kernel_roofline, _qr_roofline


def read(tr):
    return _kernel_roofline.share(tr, "qr_panel", "qr_panel_",
                                  _qr_roofline.qr_panel_counts)
