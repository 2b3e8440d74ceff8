"""factor_ops: device activities (kernels, copies, sets) that
``torch.profiler`` recorded per traced factor request."""


def read(tr):
    return tr.ops_per_request()
