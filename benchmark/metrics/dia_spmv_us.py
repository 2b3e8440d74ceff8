"""dia_spmv_us: device microseconds of one launch of the DIA kernel (B5,
``csrc/dia_spmv.cu``) in the traced window."""


def read(tr):
    count, seconds = tr.kernel("dia_spmv_kernel")
    return seconds / count * 1e6 if count else None
