"""solve_pairs: (step, key) pairs the f32 device sweeps run a refined
solve: the counts "pairs" of the program's spans
"superscan.solve.forward" and "superscan.solve.backward", summed a
traced solve ("superscan.solve" request).  Nothing where no such span
carries the count (a program that does not count its pairs)."""

from benchmark.metrics import _program

SWEEP = ("superscan.solve.forward", "superscan.solve.backward")


def read(tr):
    got = _program.spans(tr, root="superscan.solve")
    n = sum(s.parent == -1 for s in got)
    pairs = [s.counts["pairs"] for s in got
             if s.name in SWEEP and "pairs" in s.counts]
    if not n or not pairs:
        return None
    return sum(pairs) / n
