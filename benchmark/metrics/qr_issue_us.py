"""qr_issue_us: host microseconds a device op in the QR factor's level
loop: the summed durations of the program's spans
"mfqr.factor.assemble" and "mfqr.factor.fronts" of the traced
"mfqr.factor" requests over the device events of the trace that start
inside them."""

from benchmark.metrics import _program


def read(tr):
    return _program.issue_us(tr, ("mfqr.factor.assemble",
                                  "mfqr.factor.fronts"), "mfqr.factor")
