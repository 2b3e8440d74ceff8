"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a step that returns its state
unchanged, half of a batch left out, an answer altered where it is
produced; and, for the factor cells, a request that skips its work and
leaves the last factor as it was (caught by the launch counters, which
the kernel wrappers keep on the card only: here a wrapper counts).  (No cell spans chips, so none can leave out an exchange.)
The runs skip the runner's look for a card and run the kernels' plain
versions on the CPU, at the tiny sizes of ``tiny_root``."""

import pytest
import torch

import tpusparse_torch.device.kernels as kernels
import tpusparse_torch.device.spmv as spmv_mod
import tpusparse_torch.device.superscan as ss

from benchmark import harness


def _half(a: dict) -> dict:
    bs = next(iter(a.values())).shape[0]
    return {k: v[:max(bs // 2, 1)] for k, v in a.items()}


def _chol_half(tiles, _f=ss.chol_tiles):
    """The second half of the batch's tiles left unfactored."""
    out = _f(tiles).clone()
    h = tiles.shape[0] // 2
    out[h:] = torch.tril(tiles[h:])
    return out


def _od_half(a, xpad, delta, backward, _f=ss._od_apply):
    h = _half(a)
    return _f(h, xpad, delta[:next(iter(h.values())).shape[0]], backward)


def _chol_altered(tiles, _f=ss.chol_tiles):
    out = _f(tiles).clone()
    out[0, 0, 0] *= 1.01
    return out


def _solve_altered(self, b, refine_iters=3, _f=ss.SuperscanCholesky.solve):
    x = _f(self, b, refine_iters).copy()
    x[0] += 1e-6 * abs(x).max()
    return x


def _dia_half(bands, offsets, x, _f=spmv_mod.dia_spmv):
    y = _f(bands, offsets, x).clone()
    y[y.shape[0] // 2:] = 0
    return y


def _dia_altered(bands, offsets, x, _f=spmv_mod.dia_spmv):
    y = _f(bands, offsets, x).clone()
    y[3] += 1e-3 * y.abs().max()
    return y


def _factor_skipped(self, _f=ss.SuperscanCholesky.factor):
    """After the first factor, a factor() that does nothing."""
    return True if self.pools is not None else _f(self)


def _counted(tiles, _f=ss.chol_tiles):
    kernels.chol_tiles.launches += 1
    return _f(tiles)


FAULTS = {
    ("factor", "unchanged"): (ss, "_factor",
                              lambda plan, pools, *a, **k: pools),
    ("factor", "half_batch"): (ss, "chol_tiles", _chol_half),
    ("factor", "altered"): (ss, "chol_tiles", _chol_altered),
    ("factor", "skipped"): (ss.SuperscanCholesky, "factor", _factor_skipped),
    ("solve", "unchanged"): (ss.SuperscanCholesky, "_solve_f32_many",
                             lambda self, Bm, *a, **k: Bm.copy()),
    ("solve", "half_batch"): (ss, "_od_apply", _od_half),
    ("solve", "altered"): (ss.SuperscanCholesky, "solve", _solve_altered),
    ("spmv", "unchanged"): (spmv_mod, "dia_spmv",
                            lambda bands, offsets, x: x.clone()),
    ("spmv", "half_batch"): (spmv_mod, "dia_spmv", _dia_half),
    ("spmv", "altered"): (spmv_mod, "dia_spmv", _dia_altered),
}
CELLS = {"factor": ["poisson3d_g48.factor"],
         "solve": ["poisson3d_g48.solve"], "spmv": ["poisson3d_g200.spmv"]}
CASES = [(cell, fault) for (kind, fault) in FAULTS for cell in CELLS[kind]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    kind = cell.split(".")[1]
    target, attr, fn = FAULTS[(kind, fault)]
    monkeypatch.setattr(ss, "chol_tiles", _counted)
    monkeypatch.setattr(target, attr, fn)
    r = harness.run_cell(tiny_root, cell, 2 ** 31 + 9, 0.2, False,
                         device="cpu")
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", [c for cs in CELLS.values() for c in cs])
def test_the_same_runs_unbroken_are_correct(tiny_root, monkeypatch, cell):
    monkeypatch.setattr(ss, "chol_tiles", _counted)
    r = harness.run_cell(tiny_root, cell, 2 ** 31 + 9, 0.2, False,
                         device="cpu")
    assert r["correct"] is True, r["checks"]
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_the_first_sweep_is_read_without_the_private_method(tiny_root,
                                                            monkeypatch):
    """Where the program no longer calls ``_solve_f32`` the first sweeps
    are read by the public ``solve(b, refine_iters=0)``: the run stays
    correct, and a sweep broken underneath still shows."""
    from tpusparse_torch.device.refine import refine

    def solve(self, b, refine_iters=3):
        return refine(self.A, lambda r: self._solve_f32_many(
            r[:, None])[:, 0], b, iters=refine_iters)
    monkeypatch.delattr(ss.SuperscanCholesky, "_solve_f32")
    monkeypatch.setattr(ss.SuperscanCholesky, "solve", solve)
    r = harness.run_cell(tiny_root, "poisson3d_g48.solve", 2 ** 31 + 9, 0.2,
                         False, device="cpu")
    assert r["correct"] is True, r["checks"]
    monkeypatch.setattr(ss, "_od_apply", _od_half)
    r = harness.run_cell(tiny_root, "poisson3d_g48.solve", 2 ** 31 + 9, 0.2,
                         False, device="cpu")
    assert r["correct"] is False, r["checks"]
