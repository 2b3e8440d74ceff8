"""many_sweeps: f32 device sweeps a refined block solve: the count
"sweeps" of the program's span "superscan.solve_many", mean over the
traced block solves."""

from benchmark.metrics import _program


def read(tr):
    return _program.per_request(tr, "superscan.solve_many",
                                "superscan.solve_many",
                                lambda s: s.counts.get("sweeps", 0))
