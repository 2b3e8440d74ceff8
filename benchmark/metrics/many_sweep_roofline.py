"""many_sweep_roofline: the block solve's f32 sweeps against their
roofline, in %: the sum of each traced sweep's bound
(``_solve_roofline.sweep_counts`` from the plan's lnz, n and k) over the
device time of the events that start inside the program's spans
"superscan.solve.sweep" of the traced "superscan.solve_many" requests
(the spans hold the download's sync)."""

from benchmark.metrics import _solve_roofline


def read(tr):
    return _solve_roofline.share(tr)
