"""spmv_issue_us: the median host time of one ``SpmvPlan.apply`` plus the
carry, in microseconds, from the benchmark's "spmv.apply" spans before
the traced window.  The host does not wait on the device there, so this
is the time to issue one apply."""

import statistics


def read(tr):
    spans = tr.spans_before("spmv.apply")
    return statistics.median(spans) * 1e6 if spans else None
