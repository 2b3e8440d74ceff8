"""dia_spmv_roofline: B5 (``csrc/dia_spmv.cu``) against its roofline
(``_roofline.spmv_counts`` of the cell's matrix, every launch of the
traced window the same product), in %.  The matrix has to be larger
than the card's 50 MB L2 for an HBM bound to hold: the SpMV op states
its rows and entries in the trace's facts."""

from benchmark.metrics import _roofline


def read(tr):
    count, seconds = tr.kernel("dia_spmv_kernel")
    f = tr.facts
    if not count or not seconds or "nnz" not in f:
        return None
    bound = _roofline.bound_s(*_roofline.spmv_counts(f["m"], f["n"],
                                                     f["nnz"]))
    return 100.0 * count * bound / seconds
