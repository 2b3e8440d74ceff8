"""The reader ``solve_pairs`` on the CPU: on a recorded refined solve of
the tiny solve configuration in a synthetic trace it reads the window's
``pairs`` a request, which is the sweeps times two directions times the
packed schedule's pairs; it reads nothing for a window without the
spans, for a program without the recorder, or for one whose sweep spans
do not count their pairs."""

import os
import time

import numpy as np
import pytest

from conftest import ROOT, TINY

from benchmark import harness
from benchmark.matrices import poisson3d
from benchmark.trace import Trace
from tpusparse_torch.core.matrix import CSCMatrix
from tpusparse_torch.device.superscan import SuperscanCholesky
from tpusparse_torch.utils import profiling

SWEEP = ("superscan.solve.forward", "superscan.solve.backward")


@pytest.fixture(scope="module")
def solver():
    A = poisson3d.build({"grid": TINY["poisson3d_g48"],
                         "coef": [1.0, 1.0, 1.0]}, None)
    F = SuperscanCholesky(CSCMatrix(*A), order=1, device="cpu")
    assert F.factor()
    return F


def _solves(F, requests: int) -> tuple:
    """(t0, t1, spans) of ``requests`` refined solves recorded."""
    profiling.clear()
    b = np.linspace(-1, 1, F.A.n)
    with profiling.recording() as rec:
        t0 = time.time_ns()
        for _ in range(requests):
            F.solve(b)
        t1 = time.time_ns()
    return t0, t1, rec


def _trace(t0, t1, requests: int = 1) -> Trace:
    return Trace(cell="tiny", t0=t0, t1=t1, requests=requests,
                 events=[("kernel", t0, t0 + 1)], traced_device=True)


def _reader():
    return harness._load(os.path.join(ROOT, "benchmark", "metrics",
                                      "solve_pairs.py"),
                         "benchmark.metrics.solve_pairs")


@pytest.mark.parametrize("requests", [1, 2])
def test_reads_the_pairs_of_the_window(solver, requests):
    t0, t1, rec = _solves(solver, requests)
    got = _reader().read(_trace(t0, t1, requests))
    pairs = sum(map(len, solver._sched()))
    sweeps = sum(s.counts["sweeps"] for s in rec
                 if s.name == "superscan.solve")
    assert pairs > 0 and sweeps >= requests
    assert got == sum(s.counts["pairs"] for s in rec
                      if s.name in SWEEP) / requests
    assert got == sweeps * 2 * pairs / requests


def test_reads_nothing_outside_the_spans(solver):
    t0, t1, _ = _solves(solver, 1)
    assert _reader().read(_trace(t1 + 1, t1 + 10 ** 9)) is None
    assert _reader().read(_trace(t0 - 10 ** 9, t0 - 1)) is None


def test_reads_nothing_without_the_recorder(solver, monkeypatch):
    t0, t1, _ = _solves(solver, 1)
    monkeypatch.delattr(profiling, "spans")
    assert _reader().read(_trace(t0, t1)) is None


def test_reads_nothing_where_the_sweeps_do_not_count_pairs(solver,
                                                          monkeypatch):
    """A program whose forward and backward spans carry no ``pairs`` (the
    parent of the change that counts them): None, not 0."""
    t0, t1, rec = _solves(solver, 1)
    for s in rec:
        s.counts.pop("pairs", None)
    monkeypatch.setattr(profiling, "spans", lambda: list(rec))
    assert _reader().read(_trace(t0, t1)) is None
