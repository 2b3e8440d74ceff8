"""device_idle.solve: 1 - the union of the device activity intervals / the
traced window, in the solve cells."""


def read(tr):
    return tr.idle_share()
