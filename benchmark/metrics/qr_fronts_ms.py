"""qr_fronts_ms: the host time of a QR factor's front factorizations, in
ms: the summed self time of the program's spans "mfqr.factor.fronts"
(each level's bucket batches gathered, factored by H2 panels and
compact-WY ``bmm`` updates, and written back) a traced "mfqr.factor"
request."""

from benchmark.metrics import _program


def read(tr):
    got = _program.per_request(tr, "mfqr.factor.fronts", "mfqr.factor",
                               lambda s: s.self_ns)
    return None if got is None else got / 1e6
