"""solve_ops: device activities (kernels, copies, sets) that
``torch.profiler`` recorded per traced refined solve."""


def read(tr):
    return tr.ops_per_request()
