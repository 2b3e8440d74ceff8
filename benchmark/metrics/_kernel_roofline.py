"""A tile kernel's share of its roofline over the traced window:
sum of each recorded launch's bound / the kernel's device time, in %.
The launches are the shapes that the benchmark's wrapper of the engine's
call site recorded; where their count differs from the kernel's
launches in the trace, the reading is not sound and nothing is read."""

import sys

from benchmark.metrics import _roofline


def share(tr, wrapper: str, kernel: str, counts) -> float:
    shapes = tr.launches.get(wrapper, [])
    count, seconds = tr.kernel(kernel)
    if not count or not seconds:
        return None
    if count != len(shapes):
        print(f"{wrapper}: {len(shapes)} launches recorded, {count} "
              f"{kernel} in the trace: no roofline read", file=sys.stderr)
        return None
    bound = sum(_roofline.bound_s(*counts(s)) for s in shapes)
    return 100.0 * bound / seconds
