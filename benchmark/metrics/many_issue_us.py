"""many_issue_us: host microseconds a device op in the block solve's
sweeps: the summed durations of the program's spans
"superscan.solve.forward" and "superscan.solve.backward" of the traced
block solves ("superscan.solve_many" requests) over the device events
of the trace that start inside them."""

from benchmark.metrics import _program


def read(tr):
    return _program.issue_us(tr, ("superscan.solve.forward",
                                  "superscan.solve.backward"),
                             "superscan.solve_many")
