"""The port's span recorder (``tpusparse_torch.utils.profiling``) and the
spans of the superscan factor, solve and SpMV and of the multifrontal QR
factor, on the CPU: off unless asked for or under a profiler, the
factors' trees and counts held to the plan, the buffer's bound, errors,
the Chrome trace and the off cost."""

import collections
import json
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark.matrices import poisson_ls
from tpusparse_torch.core import CSCMatrix
from tpusparse_torch.device import dense, superscan
from tpusparse_torch.device.mfqr import MultifrontalQR
from tpusparse_torch.device.spmv import spmv_plan
from tpusparse_torch.utils import profiling, trace
from tpusparse_torch.utils.profiling import add, recording, span

PHASES = {"superscan.factor.update", "superscan.factor.chol",
          "superscan.factor.trsm"}
PARENT = {"superscan.factor.upload": "superscan.factor",
          "superscan.factor.segment": "superscan.factor",
          "superscan.factor.check": "superscan.factor",
          **{p: "superscan.factor.segment" for p in PHASES},
          "superscan.solve.sweep": "superscan.solve",
          "superscan.solve.forward": "superscan.solve.sweep",
          "superscan.solve.backward": "superscan.solve.sweep"}


def _grid3d(g: int) -> CSCMatrix:
    """The 7-point 3D Laplacian on g^3 (6 on the diagonal)."""
    n = g ** 3
    ex = -np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0
    ey = -np.ones(n - g)
    ey[((np.arange(g, n) // g) % g) == 0] = 0
    ez = -np.ones(n - g * g)
    S = sp.diags([6.0 * np.ones(n), ex, ex, ey, ey, ez, ez],
                 [0, 1, -1, g, -g, g * g, -g * g], format="csc")
    S.sort_indices()
    return CSCMatrix(n, n, S.indptr, S.indices, S.data)


def _spd(n: int) -> CSCMatrix:
    rng = np.random.default_rng(n)
    d = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.08)
    S = sp.csc_matrix(d @ d.T + n * np.eye(n))
    S.sort_indices()
    return CSCMatrix(n, n, S.indptr, S.indices, S.data)


MATRICES = {"grid6": lambda: _grid3d(6), "spd150": lambda: _spd(150)}


@pytest.fixture(scope="module")
def factored():
    F = superscan.SuperscanCholesky(_grid3d(5), order=1, device="cpu")
    assert F.factor()
    return F


def _run(what: str, F):
    if what == "factor":
        assert F.factor()
    elif what == "solve":
        F.solve(np.ones(F.A.n))
    else:
        spmv_plan(F.A, "auto", device="cpu").apply(torch.ones(F.A.n))


@pytest.mark.parametrize("what", ["factor", "solve", "apply"])
def test_recording_is_off_by_default(factored, what):
    before = profiling.spans()
    _run(what, factored)
    assert [s.index for s in profiling.spans()] == [s.index for s in before]


def _assert_tree(rec: list) -> dict:
    """One root; each span's parent and root as PARENT says, children
    inside their parents, every span closed.  Returns the spans by
    index."""
    by = {s.index: s for s in rec}
    roots = [s for s in rec if s.parent == -1]
    assert len(roots) == 1
    for s in rec:
        assert s.end is not None and s.start <= s.end
        assert s.root == roots[0].index
        if s.parent != -1:
            p = by[s.parent]
            assert p.name == PARENT[s.name], s
            assert p.start <= s.start and s.end <= p.end
    return by


def _assert_tree_named(rec: list, prefix: str) -> tuple:
    """One root named ``prefix``; every other span named ``prefix.<x>``
    and inside its parent.  Returns (spans by index, the root)."""
    by = {s.index: s for s in rec}
    root, = [s for s in rec if s.parent == -1]
    assert root.name == prefix
    for s in rec:
        assert s.end is not None and s.root == root.index
        if s is not root:
            assert s.name.startswith(prefix + ".")
            p = by[s.parent]
            assert p.start <= s.start and s.end <= p.end
    return by, root


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_factor_spans_form_the_tree(matrix):
    """The factor's spans form the tree of the span table; a phase span
    appears once per step that runs the phase, counted here by wrapping
    the phases' runners in a factor of the same plan."""
    F = superscan.SuperscanCholesky(MATRICES[matrix](), order=1,
                                    device="cpu")
    with recording() as rec:
        assert F.factor()
    by = _assert_tree(rec)
    root = next(s for s in rec if s.parent == -1)
    assert root.name == "superscan.factor"
    names = collections.Counter(s.name for s in rec)
    segs = [s for s in F.plan.segments if s.xs]
    # the pools' upload in factor(), then the schedule's in _factor(),
    # in the plan's first factor only
    assert names["superscan.factor.upload"] == 2
    assert names["superscan.factor.check"] == 1
    assert names["superscan.factor.segment"] == len(segs)
    assert root.counts == {"sched_uploads": 1}
    assert all(s.counts == {} for s in rec
               if s.name != "superscan.factor.upload" and s is not root)

    runs = collections.Counter()

    def counted(name, run):
        def wrapped(pools, its, c):
            runs[name] += 1
            run(pools, its, c)
        return wrapped
    phases = superscan._Phases("superscan.factor", tuple(
        (name, kinds, counted(name, run))
        for name, kinds, run in superscan._FACTOR_PHASES.runs))
    superscan._factor(F.plan, superscan.pools_from_numpy(
        F.plan.pool_init, "cpu"), phases=phases)
    assert {p: names[p] for p in PHASES} == {p: runs[p] for p in PHASES}
    for p in PHASES:
        assert all(by[s.parent].name == "superscan.factor.segment"
                   for s in rec if s.name == p)
    # a segment's phase spans lie inside it, steps times at most
    segments = [s for s in rec if s.name == "superscan.factor.segment"]
    for s, seg in zip(segments, segs):
        kids = [k for k in rec if k.parent == s.index]
        assert len(kids) <= 3 * (seg.hi - seg.lo)


def test_h2d_bytes_are_the_pools_and_the_schedule():
    """``h2d_bytes`` of the two upload spans: the pools in f32, then the
    packed int32 factor schedule, from the plan."""
    F = superscan.SuperscanCholesky(_grid3d(6), order=1, device="cpu")
    plan = F.plan
    pools = sum(np.asarray(v).shape[0] * np.asarray(v).shape[1] * 4
                for v in plan.pool_init.values())
    sched = sum(a.size * a.itemsize for s in plan.segments if s.xs
                for d in s.xs.values() for a in d.values())
    assert all(a.dtype == np.int32 for s in plan.segments if s.xs
               for d in s.xs.values() for a in d.values())
    with recording() as rec:
        assert F.factor()
    up = [s.counts for s in rec if s.name == "superscan.factor.upload"]
    assert up == [{"h2d_bytes": pools}, {"h2d_bytes": sched}]


@pytest.mark.parametrize("iters", [0, 3])
def test_sweeps_count_the_f32_solves(factored, iters):
    """``sweeps`` on the solve span equals the calls of ``_solve_f32``,
    counted by a wrapper as the benchmark's solve op wraps it; each sweep
    has its forward and backward spans."""
    F = factored
    calls = []
    sweep = type(F)._solve_f32

    def wrapped(b):
        calls.append(1)
        return sweep(F, b)
    F._solve_f32 = wrapped
    try:
        b = np.random.default_rng(iters).uniform(-1, 1, F.A.n)
        with recording() as rec:
            F.solve(b, refine_iters=iters)
    finally:
        del F._solve_f32
    by = _assert_tree(rec)
    root = next(s for s in rec if s.parent == -1)
    assert root.name == "superscan.solve"
    assert root.counts == {"sweeps": len(calls)} and len(calls) >= 1
    sweeps = [s for s in rec if s.name == "superscan.solve.sweep"]
    assert len(sweeps) == len(calls)
    assert all(s.counts == {} for s in sweeps)
    for name in ("superscan.solve.forward", "superscan.solve.backward"):
        assert sorted(by[s.parent].index for s in rec if s.name == name) \
            == [s.index for s in sweeps]


def test_pairs_count_the_packed_schedule(factored):
    """``pairs`` on every forward and backward span of a refined solve is
    the packed solve schedule's pair count: the (step, key) pairs of
    ``_solve_xs`` that hold a real slot, fewer than it has."""
    F = factored
    with recording() as rec:
        F.solve(np.linspace(-1, 1, F.A.n))
    full = [xs for xs in superscan._solve_xs(F.plan) if xs]
    pairs = sum(len(st) for xs in full
                for st in superscan._solve_steps(xs, F.plan.n))
    assert pairs == sum(map(len, F._sched()))
    assert 0 < pairs < sum(len(xs) * next(iter(next(iter(
        xs.values())).values())).shape[0] for xs in full)
    root = next(s for s in rec if s.parent == -1)
    for name in ("superscan.solve.forward", "superscan.solve.backward"):
        got = [s.counts for s in rec if s.name == name]
        assert got == [{"pairs": pairs}] * root.counts["sweeps"]


class _CountedLen(dict):
    """A step of the solve schedule that counts the calls of ``len``."""
    calls = 0

    def __len__(self):
        _CountedLen.calls += 1
        return super().__len__()


def test_pairs_are_not_computed_when_nothing_records(factored,
                                                     monkeypatch):
    """Off, the sweep neither sums its pairs nor counts them; recording,
    it sums each step's pairs once a direction."""
    F = factored
    sched = [_CountedLen(xs) for xs in F._sched()]
    monkeypatch.setattr(F, "_solve_sched", sched)
    monkeypatch.setattr(_CountedLen, "calls", 0)
    b = np.ones((F.A.n, 1))
    before = [s.index for s in profiling.spans()]
    F._solve_f32_many(b)
    assert _CountedLen.calls == 0
    assert [s.index for s in profiling.spans()] == before
    with recording() as rec:
        F._solve_f32_many(b)
    assert _CountedLen.calls == 2 * len(sched)
    assert [s.counts for s in rec if s.name.startswith(
        "superscan.solve.")] == [{}, {"pairs": sum(map(len, sched))},
                                 {"pairs": sum(map(len, sched))}]


def test_lu_sweep_names_its_own_spans():
    """The LU's f32 sweep, the Cholesky's shared ``_solve_sweep``, records
    its spans under ``superscan_lu.solve``: the forward and backward
    spans inside the sweep's, each counting the pairs of the LU's packed
    schedule."""
    from tpusparse_torch.device.superscan_lu import SuperscanLU
    F = SuperscanLU(_grid3d(5), order=1, device="cpu")
    assert F.factor()
    with recording() as rec:
        F._solve_f32_many(np.ones((F.A.n, 2)))
    root = rec[0]
    assert all(root.start <= s.start and s.end <= root.end for s in rec)
    pairs = sum(map(len, F._sched()))
    assert pairs > 0
    assert [(s.name, s.parent, s.counts) for s in rec] == [
        ("superscan_lu.solve.sweep", -1, {}),
        ("superscan_lu.solve.forward", root.index, {"pairs": pairs}),
        ("superscan_lu.solve.backward", root.index, {"pairs": pairs})]


def test_apply_records_one_span(factored):
    plan = spmv_plan(factored.A, "auto", device="cpu")
    with recording() as rec:
        plan.apply(torch.ones(factored.A.n))
    assert [(s.name, s.parent, s.counts) for s in rec] == [
        ("spmv.plan.apply", -1, {})]


def test_a_profiler_turns_recording_on():
    from torch.profiler import ProfilerActivity, profile
    before = [s.index for s in profiling.spans()]
    with span("off"):
        pass
    assert [s.index for s in profiling.spans()] == before
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with span("on"):
            add("n", 2)
        t1 = time.time_ns()
    last = profiling.spans()[-1]
    assert (last.name, last.counts) == ("on", {"n": 2})
    assert t0 <= last.start <= last.end <= t1
    with span("after"):
        pass
    assert profiling.spans()[-1] is last


def test_a_raising_body_closes_its_span():
    with recording() as rec:
        with pytest.raises(KeyError, match="body"):
            with span("outer"):
                with span("inner"):
                    raise KeyError("body")
        with span("next"):
            pass
    outer, inner, nxt = rec
    assert inner.end is not None and outer.end is not None
    assert inner.parent == outer.index and nxt.parent == -1
    assert profiling._stack == []


def test_the_bound_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "_buffer", collections.deque(maxlen=4))
    monkeypatch.setattr(profiling, "_dropped", 0)
    with recording() as rec:
        for i in range(7):
            with span(f"s{i}"):
                add("i", i)
    assert [s.name for s in rec] == ["s3", "s4", "s5", "s6"]
    assert [s.name for s in profiling.spans()] == ["s3", "s4", "s5", "s6"]
    assert profiling.dropped() == 3
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_recording_nests_and_add_outside_a_span_does_nothing():
    add("lost", 1)
    with recording() as outer:
        with span("a"):
            pass
        with recording() as inner:
            with span("b"):
                add("k")
                add("k", 2)
        with span("c"):
            pass
    assert [s.name for s in inner] == ["b"] and inner[0].counts == {"k": 3}
    assert [s.name for s in outer] == ["a", "b", "c"]
    assert profiling._depth == 0


def test_trace_names_the_program_spans(tmp_path, monkeypatch, factored):
    """The Chrome trace holds the factor's spans, with their counts, on
    the file's clock: the profiler's own ops start inside the root."""
    monkeypatch.setenv("TPUSPARSE_TRACE_DIR", str(tmp_path))
    with trace("factor"):
        assert factored.factor()
    with open(tmp_path / "factor.json") as f:
        events = json.load(f)["traceEvents"]
    ours = [ev for ev in events if ev.get("cat") == "tpusparse"]
    names = {ev["name"] for ev in ours}
    assert {"superscan.factor", "superscan.factor.upload",
            "superscan.factor.segment", "superscan.factor.check"} <= names
    assert names & PHASES
    assert sum(ev["args"].get("h2d_bytes", 0) for ev in ours) > 0
    root, = [ev for ev in ours if ev["name"] == "superscan.factor"]
    ops = [ev["ts"] for ev in events if ev.get("cat") == "cpu_op"]
    inside = sum(root["ts"] <= t <= root["ts"] + root["dur"] for t in ops)
    assert ops and inside >= 0.9 * len(ops)


def _other_factor(kind: str):
    """(factor(), root name, plan) of an engine that shares the
    superscan step loop: the LU factor, and the sharded factors on a
    one-rank stand-in for the mesh (whose only part they read here is
    ``gather_batches``)."""
    from types import SimpleNamespace
    from tpusparse_torch.device.batching import whole
    from tpusparse_torch.device.superscan_lu import SuperscanLU
    from tpusparse_torch.parallel import sharded
    mesh = SimpleNamespace(gather_batches=whole)
    if kind == "lu":
        F = SuperscanLU(_grid3d(5), order=1, device="cpu")
        return F.factor, "superscan_lu.factor", F.plan
    if kind == "sharded_lu":
        F = SuperscanLU(_grid3d(5), order=1, device="cpu")
        return (sharded.sharded_superscan_lu_factor(F, mesh),
                "sharded.superscan_lu.factor", F.plan)
    F = superscan.SuperscanCholesky(_grid3d(5), order=1, device="cpu")
    run = sharded.sharded_superscan_factor(F.plan, mesh)
    return (lambda: run(superscan.pools_from_numpy(F.plan.pool_init, "cpu")),
            "sharded.superscan.factor", F.plan)


@pytest.mark.parametrize("kind", ["lu", "sharded", "sharded_lu"])
def test_other_factors_name_their_own_spans(kind):
    """The engines that share the step loop record it under their own
    root and names: no span of theirs carries the Cholesky factor's."""
    factor, name, plan = _other_factor(kind)
    with recording() as rec:
        assert factor() is not False
    _assert_tree_named(rec, name)
    names = collections.Counter(s.name for s in rec)
    # the schedule's upload, and the LU's pools' copy from its host pools
    assert names[f"{name}.upload"] == 1 + kind.endswith("lu")
    assert names[f"{name}.segment"] == len([s for s in plan.segments
                                            if s.xs])
    assert names[f"{name}.update"] > 0 and names[f"{name}.trsm"] > 0
    assert not any(n.startswith("superscan.") for n in names)


@pytest.mark.parametrize("kind", ["lu", "sharded", "sharded_lu"])
def test_other_factors_keep_their_schedule_resident(kind):
    """The engines that share the step loop upload their factor schedule
    in their first factor only: ``sched_uploads`` on their root reads 1
    with one upload span, then 0 with none; the LU factors also copy
    their pools in an upload span of every factor."""
    factor, name, _ = _other_factor(kind)
    got = []
    for _ in range(2):
        with recording() as rec:
            assert factor() is not False
        root, = [s for s in rec if s.parent == -1]
        got.append((root.counts["sched_uploads"],
                    [s.name for s in rec].count(f"{name}.upload")))
    pools = int(kind.endswith("lu"))
    assert got == [(1, 1 + pools), (0, pools)]


# ------------------------------------------------------ multifrontal QR
def _poisson_ls(g: int) -> CSCMatrix:
    """[L; 0.5 I], L the 5-point Laplacian on the g x g grid (the
    benchmark's QR matrix)."""
    return CSCMatrix(*poisson_ls.build({"grid": g, "alpha": 0.5}, None))


def _index_bytes(sched) -> int:
    """Bytes of every index tensor of an mfqr ``_Sched``, walked."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.nbytes
        if isinstance(x, dict):
            return walk(list(x.values()))
        if isinstance(x, (list, tuple)):
            return sum(map(walk, x))
        return 0
    return walk([sched.factor, sched.assemble, sched.disassemble, sched.io,
                 sched.rsolve, sched.pass_rows, sched.pass_slots])


def test_qr_factor_spans_form_the_tree(monkeypatch):
    """A recorded ``MultifrontalQR.factor()``: the root ``mfqr.factor``
    over the upload, one assembly and one fronts span a level in level
    order, and the rank check; ``panels`` on each fronts span is its
    level's H2 launches and on the root the factor's, both counted by a
    wrapper of ``dense.qr_panel`` (the call site ``qr_factor_partial``
    launches through); the first factor uploads the scattered A and the
    schedule (``sched_uploads`` 1, ``h2d_bytes`` both), the next
    neither."""
    launched = []
    panel = dense.qr_panel

    def counted(*a):
        launched.append(a[0].shape)
        return panel(*a)
    monkeypatch.setattr(dense, "qr_panel", counted)
    F = MultifrontalQR(_poisson_ls(8), device="cpu")
    L = F.plan.nlevels
    got = []
    for _ in range(2):
        launched.clear()
        with recording() as rec:
            assert F.factor()
        by, root = _assert_tree_named(rec, "mfqr.factor")
        assert all(by[s.parent] is root for s in rec if s is not root)
        assert [s.name[len("mfqr.factor."):] for s in rec[1:]] == (
            ["upload"] + ["assemble", "fronts"] * L + ["check"])
        fronts = [s.counts["panels"] for s in rec
                  if s.name == "mfqr.factor.fronts"]
        assert fronts == [sum(-(-min(b) // 8) for b in lf)
                          for lf in F.plan.level_factor]
        assert root.counts["panels"] == sum(fronts) == len(launched) > 0
        up, = [s.counts for s in rec if s.name == "mfqr.factor.upload"]
        assert all(s.counts == {} for s in rec if s.name in (
            "mfqr.factor.assemble", "mfqr.factor.check"))
        got.append((root.counts["sched_uploads"], up["h2d_bytes"]))
    pools = sum(v.nbytes for v in F.plan.pool_init.values())
    assert got == [(1, pools + _index_bytes(F._sched)), (0, 0)]
    assert _index_bytes(F._sched) == F._sched.nbytes > 0


def test_qr_factor_records_nothing_when_off():
    F = MultifrontalQR(_poisson_ls(6), device="cpu")
    before = [s.index for s in profiling.spans()]
    assert F.factor() and F.factor()
    assert [s.index for s in profiling.spans()] == before


def test_the_off_cost_of_a_span():
    """Off, ``with span(name):`` costs under 0.3 us: the best of 50 rounds
    of 10^5 on the thread's CPU clock (which other processes' load does
    not stretch), less the same loop with an empty body."""
    assert not (profiling._depth or profiling._torch_profiler
                ._is_profiler_enabled)
    best = float("inf")
    for _ in range(50):
        t = time.thread_time_ns()
        for _ in range(100_000):
            with span("superscan.factor.update"):
                pass
        t1 = time.thread_time_ns()
        for _ in range(100_000):
            pass
        best = min(best, (t1 - t) - (time.thread_time_ns() - t1))
    assert best / 100_000 < 300, f"{best / 100_000:.1f} ns a span"
