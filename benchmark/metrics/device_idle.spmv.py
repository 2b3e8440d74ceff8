"""device_idle.spmv: 1 - the union of the device activity intervals / the
traced window, in the spmv cells."""


def read(tr):
    return tr.idle_share()
