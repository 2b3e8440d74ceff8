"""device_idle.factor: 1 - the union of the device activity intervals / the
traced window, in the factor cells."""


def read(tr):
    return tr.idle_share()
