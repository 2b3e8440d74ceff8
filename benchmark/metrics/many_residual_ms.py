"""many_residual_ms: a refined block solve's host time in its f64
residuals, in ms: the self time of the program's spans
"refine_many.residual" (``device.refine_many``, one a refinement step),
summed a traced block solve ("superscan.solve_many" request)."""

from benchmark.metrics import _program


def read(tr):
    got = _program.per_request(tr, "refine_many.residual",
                               "superscan.solve_many", lambda s: s.self_ns)
    return None if got is None else got / 1e6
