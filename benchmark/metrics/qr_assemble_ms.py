"""qr_assemble_ms: the host time of a QR factor's contribution assembly,
in ms: the summed self time of the program's spans
"mfqr.factor.assemble" (each child's rows gathered, masked to their
upper trapezoid and added into the parent fronts, one span a level) a
traced "mfqr.factor" request."""

from benchmark.metrics import _program


def read(tr):
    got = _program.per_request(tr, "mfqr.factor.assemble", "mfqr.factor",
                               lambda s: s.self_ns)
    return None if got is None else got / 1e6
