"""device_idle.qr_factor: 1 - the union of the device activity intervals /
the traced window, in the QR factor cells."""


def read(tr):
    return tr.idle_share()
