"""refine_share: the share of a refined solve's wall spent outside its f32
device sweeps (host refinement: residuals in f64, corrections), from the
benchmark's spans around each solve ("refine") and each sweep
("solve.sweep"), over the solves before the traced window."""


def read(tr):
    solves = tr.spans_before("refine")
    sweeps = tr.spans_before("solve.sweep")
    if not solves or not sum(solves):
        return None
    return 1.0 - sum(sweeps) / sum(solves)
