"""plan_s: seconds the set-up spent in the solver's construction, which is
the host planner (``device.superscan_plan`` and ``native``); host clock."""


def read(tr):
    return tr.timings.get("plan_s")
