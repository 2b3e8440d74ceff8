"""The byte and operation counts of H2 (``csrc/qr_panel.cu``, launched
through ``dense.qr_panel``), for ``qr_panel_roofline``, against the
peaks of ``_roofline``.

A launch on (P, r, pb) factors P panels of r rows (the front's rows from
k0 on) and pb columns.  Bytes, in float32: each panel read once and
written back once (2 r pb), and V (r pb), T (pb^2) and the taus (pb)
written once: 4 P (3 r pb + pb^2 + pb).  Operations, a panel:
Householder QR's on r x pb, 2 pb^2 (r - pb / 3) (LAPACK's geqrf count),
plus T's formation, pb (pb - 1) / 2 inner products of length r and the
triangular products, r pb (pb - 1) + (pb - 1) pb (2 pb - 1) / 6
(LAPACK's larft).  Every slot counts: the launch's shape does not say
which fronts are padding, nor how many of a front's rows are.
"""

from __future__ import annotations

from benchmark.metrics._roofline import F32


def qr_panel_counts(launch: tuple) -> tuple:
    """(bytes, operations) of ``qr_panel`` on (P, r, pb)."""
    P, r, pb = launch
    nbytes = F32 * P * (3 * r * pb + pb * pb + pb)
    qr = 2 * pb * pb * (r - pb / 3)
    t = r * pb * (pb - 1) + (pb - 1) * pb * (2 * pb - 1) / 6
    return nbytes, P * (qr + t)
