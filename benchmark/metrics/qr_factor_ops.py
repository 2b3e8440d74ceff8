"""qr_factor_ops: device activities (kernels, copies, sets) that
``torch.profiler`` recorded per traced QR factor, the requests counted
by the program's "mfqr.factor" root spans in the traced window."""

from benchmark.metrics import _program


def read(tr):
    roots = [s for s in _program.spans(tr, "mfqr.factor") if s.parent == -1]
    if not roots or not tr.traced_device or not tr.events:
        return None
    return len(tr.events) / len(roots)
