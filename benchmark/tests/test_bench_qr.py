"""The QR cell (``poisson_ls_g363.qr_factor``) on the CPU: its runs at
g=8, a broken timed path read as not correct, the plain reference's
structural faults, the matrix against ``chip_smoke.py``'s, H2's counts
and the readers of the program's spans held to ``mfqr.factor``
requests."""

import importlib.util
import json
import os
import time

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import ROOT, TINY, copy_root

import tpusparse_torch.device.dense as dense
import tpusparse_torch.device.kernels as kernels
from benchmark import harness
from benchmark.matrices import poisson3d, poisson_ls
from benchmark.metrics import _qr_roofline, _roofline
from benchmark.reference import qr as ref_qr
from benchmark.trace import Trace
from tpusparse_torch.core.matrix import CSCMatrix
from tpusparse_torch.device.mfqr import MultifrontalQR
from tpusparse_torch.device.superscan import SuperscanCholesky
from tpusparse_torch.utils import profiling

CELL = "poisson_ls_g363.qr_factor"
SEED = 2 ** 33 + 5


@pytest.fixture(scope="module")
def qr_root(tmp_path_factory):
    return copy_root(str(tmp_path_factory.mktemp("qr")),
                     dict(TINY, poisson_ls_g363=8))


def _matrix(g: int) -> tuple:
    return poisson_ls.build({"grid": g, "alpha": 0.5}, None)


def _limit() -> float:
    with open(os.path.join(ROOT, "benchmark", "limits", CELL + ".json")) as f:
        return json.load(f)["backward_error"]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_qr_cell_runs_on_the_cpu(qr_root, trace):
    r = harness.run_cell(qr_root, CELL, SEED, 0.5, bool(trace),
                         device="cpu")
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"backward_error", "launch_gap"}
    assert 0 < r["checks"]["backward_error"]["value"] < 1e-6
    # without a card no reader of this cell finds anything to read
    want = {"setup_s", "factor_ms", "peak_mib"} if not trace else set()
    assert set(r["metrics"]) == want
    assert dense.qr_panel is kernels.qr_panel


def _counted(M, taus, k0, pb, _f=dense.qr_panel):
    """H2 counted as on the card (the plain version counts nothing)."""
    kernels.qr_panel.launches += 1
    return _f(M, taus, k0, pb)


def _skipped(self, _f=MultifrontalQR.factor):
    """After the first factor, a factor() that does nothing."""
    return True if self.pools is not None else _f(self)


def _damaged(self, pools, taus, batches=None,
             _f=MultifrontalQR._factor_pools):
    """The factor, then a diagonal entry of R 1 % off."""
    _f(self, pools, taus)
    b = self.plan.buckets[-1]
    pools[b][0, 0, 0] *= 1.01


def _not_finite(self, pools, taus, batches=None,
                _f=MultifrontalQR._factor_pools):
    """After the first factor, the factor with a NaN in R: factor()
    returns False, and the request fails."""
    _f(self, pools, taus)
    if self.pools is not None:
        pools[self.plan.buckets[-1]][0, 0, 0] = float("nan")


FAULTS = {
    "damaged": (MultifrontalQR, "_factor_pools", _damaged),
    "not_finite": (MultifrontalQR, "_factor_pools", _not_finite),
    "skipped": (MultifrontalQR, "factor", _skipped),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_qr_factor_is_not_correct(qr_root, monkeypatch, fault):
    monkeypatch.setattr(dense, "qr_panel", _counted)
    target, attr, fn = FAULTS[fault]
    monkeypatch.setattr(target, attr, fn)
    r = harness.run_cell(qr_root, CELL, SEED, 0.3, False, device="cpu")
    assert r["correct"] is False, r["checks"]
    assert (r["failed"] > 0) == (fault == "not_finite")
    gap = r["checks"]["launch_gap"]["value"]
    assert (gap > 0) == (fault == "skipped")


# ----------------------------------------------------------- reference
@pytest.fixture(scope="module")
def factor():
    """(A, q, R) of the cell's op on the g=5 matrix."""
    from benchmark.ops import qr_factor
    A = _matrix(5)
    F = MultifrontalQR(CSCMatrix(*A), device="cpu")
    assert F.factor()
    return (A,) + qr_factor.collect(None, {"F": F, "gap": 0})[:2]


def _tup(S) -> tuple:
    S = S.tocsc()
    S.sort_indices()
    return (S.shape[0], S.shape[1], S.indptr.astype(np.int64),
            S.indices.astype(np.int64), S.data.astype(np.float64))


def _faulty(kind: str, q, R) -> tuple:
    q, R = q.copy(), sp.csc_matrix((R[4], R[3], R[2]), shape=R[:2]).tolil()
    if kind == "repeated_column":
        q[0] = q[1]
    elif kind == "r_below_diagonal":
        R[5, 4] = 1e-30
    elif kind == "zero_diagonal":
        R[3, 3] = 0.0
    elif kind == "nan":
        R[2, 7] = np.nan
    return q, _tup(R)


@pytest.mark.parametrize("kind", ["repeated_column", "r_below_diagonal",
                                  "zero_diagonal", "nan"])
def test_the_reference_reads_inf_on_a_broken_structure(factor, kind):
    A, q, R = factor
    rng = np.random.default_rng(7)
    sound = ref_qr.backward_error(A, q, R, rng)
    assert 0 < sound < 1e-6
    assert ref_qr.backward_error(A, *_faulty(kind, q, R), rng) == float("inf")


def test_swapped_columns_read_far_above_the_limit(factor):
    """Two columns of the order swapped is still a permutation: the
    probes read it, far above the cell's limit."""
    A, q, R = factor
    q = q.copy()
    q[[0, 1]] = q[[1, 0]]
    got = ref_qr.backward_error(A, q, R, np.random.default_rng(7))
    assert np.isfinite(got) and got > 1e3 * _limit()


def test_the_reference_takes_r_up_to_row_signs(factor):
    """R with a row negated is A_q's R too (Q takes the sign)."""
    A, q, R = factor
    S = sp.csc_matrix((R[4], R[3], R[2]), shape=R[:2]).tolil()
    S[4, :] = -S[4, :]
    rng = np.random.default_rng(7)
    assert ref_qr.backward_error(A, q, _tup(S), rng) < 1e-6


def test_the_matrix_is_chip_smokes():
    """Bit for bit the g=363 least squares that ``chip_smoke.py`` builds
    (loaded from its file: nothing in the benchmark imports it)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    B = cs.poisson_ls(7)
    A = _matrix(7)
    assert A[:2] == (B.m, B.n) == (98, 49) and A[2][-1] == 5 * 49 - 4 * 7 + 49
    for u, v in zip(A[2:], (B.indptr, B.indices, B.data)):
        assert np.array_equal(u, v) and u.dtype == np.asarray(v).dtype


# ------------------------------------------------------------ readers
def test_h2_counts_by_hand():
    """(24,459, 32, 8): the g=363 plan's most common fronts, 32 rows from
    the first panel on.  Bytes 4 P (3 r pb + pb^2 + pb) = 4 * 24,459 *
    840; operations a panel 2 * 64 * (32 - 8/3) + 32 * 8 * 7 + 7 * 8 * 15
    / 6 = 17,060 / 3."""
    nbytes, flops = _qr_roofline.qr_panel_counts((24459, 32, 8))
    assert nbytes == 82_182_240
    assert flops == pytest.approx(139_090_180, rel=1e-12)
    assert _roofline.bound_s(nbytes, flops) == 82_182_240 / 3.35e12
    reader = harness._load(os.path.join(
        ROOT, "benchmark", "metrics", "qr_panel_roofline.py"),
        "benchmark.metrics.qr_panel_roofline")
    ev = [("void (anonymous namespace)::qr_panel_warp_kernel<8, 1>(...)",
           0, 100_000), ("qr_apply_kernel", 100_000, 200_000)]
    tr = Trace(cell="h", t0=0, t1=300_000, events=ev, traced_device=True,
               launches={"qr_panel": [(24459, 32, 8)]})
    assert reader.read(tr) == pytest.approx(
        100 * 82_182_240 / 3.35e12 / 1e-4)
    tr.launches["qr_panel"].append((4, 24, 8))
    assert reader.read(tr) is None          # counts differ: not read


EVENTS_A_SPAN = 3
LOOP = ("mfqr.factor.assemble", "mfqr.factor.fronts")


def _window(run) -> tuple:
    profiling.clear()
    with profiling.recording() as rec:
        t0 = time.time_ns()
        run()
        t1 = time.time_ns()
    return t0, t1, rec


def _trace(t0, t1, rec) -> Trace:
    """EVENTS_A_SPAN synthetic device events in each span of the QR level
    loop, and one outside them."""
    events = [("outside", t0, t0 + 1)]
    for s in rec:
        if s.name in LOOP:
            step = max((s.end - s.start) // (EVENTS_A_SPAN + 1), 1)
            events += [("kernel", s.start + i * step, s.start + i * step + 1)
                       for i in range(EVENTS_A_SPAN)]
    return Trace(cell="tiny", t0=t0, t1=t1, requests=1, events=events,
                 traced_device=True)


def _self_ns(s, rec) -> int:
    return s.end - s.start - sum(k.end - k.start for k in rec
                                 if k.parent == s.index)


# reader -> the reading computed from the "mfqr.factor" request's spans
WANT = {
    "qr_assemble_ms": lambda rec, tr: sum(
        _self_ns(s, rec) for s in rec
        if s.name == "mfqr.factor.assemble") / 1e6,
    "qr_fronts_ms": lambda rec, tr: sum(
        _self_ns(s, rec) for s in rec if s.name == "mfqr.factor.fronts") / 1e6,
    "qr_issue_us": lambda rec, tr: sum(
        s.end - s.start for s in rec if s.name in LOOP)
        / (EVENTS_A_SPAN * sum(s.name in LOOP for s in rec)) / 1e3,
    "qr_factor_ops": lambda rec, tr: float(len(tr.events)),
}


def _reader(name: str):
    return harness._load(os.path.join(ROOT, "benchmark", "metrics",
                                      name + ".py"),
                         f"benchmark.metrics.{name}")


@pytest.mark.parametrize("name", sorted(WANT))
def test_qr_readers_read_only_qr_factor_requests(name):
    """A window with Cholesky factors beside one MultifrontalQR factor
    reads as that factor's spans alone give it; a window without it
    reads nothing."""
    Q = MultifrontalQR(CSCMatrix(*_matrix(6)), device="cpu")
    C = SuperscanCholesky(CSCMatrix(*poisson3d.build(
        {"grid": 6, "coef": [1.0, 1.0, 1.0]}, None)), order=1, device="cpu")

    def run():
        assert C.factor() and Q.factor() and C.factor()
    t0, t1, rec = _window(run)
    roots = {s.index for s in rec
             if s.parent == -1 and s.name == "mfqr.factor"}
    mine = [s for s in rec if s.root in roots]
    assert len(roots) == 1 and 0 < len(mine) < len(rec)
    tr = _trace(t0, t1, rec)
    got = _reader(name).read(tr)
    assert got == pytest.approx(WANT[name](mine, tr), rel=1e-12)
    assert got > 0
    t0, t1, rec = _window(lambda: C.factor())
    assert _reader(name).read(_trace(t0, t1, rec)) is None
