#!/usr/bin/env python3
"""Smoke run of tpusparse_torch on one CUDA card: the Cholesky solves
(superscan, supernodal, fixed-tile with its updown), the LU solve (lusol
-> TpuLU -> SuperscanLU) and the device SpMV end to end, through their
hand-written kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 3,8     (a partial run, while developing:
                                            phases 1 and 2 and those named,
                                            of 3 4 5 6 8 9 10 11 12 13 14;
                                            it prints no result lines)

Phases (any failure raises, so the exit code is nonzero):
  1. device: a CUDA card is present; prints nvidia-smi's name and power
     limit;
  2. build: nvcc builds tpusparse_torch/csrc/*.cu into build/ (first use);
     ptxas's registers and spills per kernel; no instance of the LU tile
     kernel may spill;
  3. kernels vs plain versions on the card, at every chol W and trsm
     (H, W) of the canonical plan, at its largest per-step batch, within
     1e-5 relative (W=128 is one tile, the (1, 128, 128) every panel of
     the fixed-tile path launches); the trsm kernels also against their
     own arithmetic in torch ops (trsm_tiles_blocked_ref, the plain
     version that is timed for them); the NaN contract of a non-SPD tile
     between good ones at B = 16, 128 and 8, and of a non-finite trsm
     slot at W = 8 and 128; CUDA-event times of kernel, plain version and
     library call, each with the stream's queue filled first, so they
     are device times (cuda_ms); the shared-L trsm at every
     (r, 128, 128) of the g=24 fixed-tile plan; one shape of each trsm
     entry at a width the plans do not produce; the latency of one
     dependent step of a Cholesky column and of a substitution column
     (a one-warp probe), which times the tile width gives each tile
     kernel its chain floor; and, once phase 5 has planned it, the chol
     and per-slot trsm kernels at the g=48 plan's largest per-step batch
     of every W and (H, W).
     Yardsticks: chol_tiles is no slower than cholesky_ex, and each trsm
     entry no slower than solve_triangular, at any shape, nor summed
     over its main-path shapes;
  4. canonical cell: 3D Laplacian g=24 (n=13,824), plan fields equal to
     the JAX planner's, factor through both kernels, refined residual
     <= 1e-14;
  5. the cholsol entry point at n=110,592 (3D Laplacian g=48), with the
     kernel launch counters reset just before it: both kernels must
     launch, plan fields as the JAX planner gives them, residual
     <= 1e-14;
  6. failure contract: a non-SPD matrix gives factor() False in each
     engine;
  8. the SpMV path, spmv_plan(A, "auto", device="cuda") -> apply, on six
     matrices (SPMV_CASES), each with the launch counters reset just
     before it: the mode, the case's kernel launched, y against scipy's
     float64 A @ x within 1e-5 * max|y|, gaxpy and apply_permuted on the
     large SELL case; plan seconds, apply time (median of 5 runs of 50
     applies with the y-carry x <- 0.125 y, CUDA events; host launch
     time included, and the device time alone and the host's time to
     queue one apply beside it), GB/s, the
     cuSPARSE CSR matvec in the same loop, spill, waste, peak memory;
  7. right after each phase-8 case, on that plan's buffers: the DIA,
     SELL (the compact pack of the v1 slabs, and of the v2 slabs of the
     RCM-ordered matrix, every S class) and BELL kernels against their
     plain versions within 1e-5 relative; device times of kernel, plain
     version and cuSPARSE as in phase 3, and the wrapper's host time per
     call; the bytes the SELL kernel reads beside the bytes the product
     needs (at most 1.15 times those) and the padded slabs' bytes.
     Yardstick: sell_spmv summed over the two kNN cases is no slower
     than the cuSPARSE CSR matvec summed over them;
  9. cholsol(1, A, b) with engine "auto" on the g=24 grid: the engine is
     SupernodalCholesky (n < 16,384), plan fields as the JAX planner
     gives them, residual <= 1e-14; it launches no kernel of this repo
     (its dense blocks go to the library calls, as in the JAX package);
 10. cholsol(1, A, b, engine="tiled") on the g=24 grid, with the launch
     counters reset just before it: the chol and shared-L trsm kernels
     must launch, plan fields, residual <= 1e-14;
 11. updown on a fixed-tile factor of the g=12 grid (demo3's recipe):
     update then downdate, each refined residual against A +- w w^T
     <= 1e-12, the pool still on the card.
Phases 9-11 print plan, factor (first and warm), solve and updown wall
times, peak device memory, and a torch.profiler window over one warm
factor (one update + downdate in 11): device ops, kernel time, busy
share and the longest kernels.
 12. the pivoted LU tile kernel (lu_tiles) against its plain version on
     the card at every panel-LU key (pw, W) of the g=40 LU plan (phase
     13's), at its largest step, with that step's real and padded slots
     (every step's padded slots must stand together at its end), for
     tol 0 (diagonally dominant tiles), 0.001 (rows swapped so that
     pivoting must undo them) and 1.0 (random normal tiles): through the
     entry the factor calls, lu_tiles_pool, in place in the step's pools
     (both pools bit for bit against its plain version), and through
     lu_tiles on the same tiles gathered (F bit for bit, P identical);
     times of lu_tiles_pool, its plain version, torch.linalg.
     lu_factor_ex on the gathered tiles and an empty launch of the same
     grid (the launch floor), and the chain floor (W LU columns of a
     one-warp probe); yardstick: lu_tiles_pool no slower than
     lu_factor_ex at any shape; tie tiles at W = 8, 24, 32, 40 and 128
     (equal candidates in moved and unmoved rows, the diagonal exactly
     at tol * max), bit for bit; lu_tiles_pool at W = 24 and 40 (widths
     no plan has) with padded slots, both pools bit for bit; the NaN
     contract (a NaN tile between good ones at W = 8, 16 and 128, P = I
     at tol 0) and the tiny-pivot contract (a pivot below eps becomes
     +-eps, W = 8, 16, 128); then trsm_tiles_batched at every (H, W) of
     that plan's trsm phases in both of the LU's operand forms (as in 14,
     off the kernels line);
 13. the BENCH_r05 LU cell: SuperscanLU(conv_diff_3d(40), order 0,
     max_segments 12), plan fields equal to BENCH_r05's, the launch
     counters reset just before the first factor: lu_tiles (through
     lu_tiles_pool) once per non-empty panel-LU phase of the plan and
     trsm_tiles_batched twice per non-empty trsm phase, no other kernel;
     factor first and warm, growth, refined residual <= 1e-14, peak
     device memory and a torch.profiler window over the last segments of
     a warm factor that hold a tenth of its steps (H1's and B2's kernel
     time named); in a partial run only (--phases 13), two more factors
     with deterministic index_add_, one through lu_tiles_pool and one
     through the gather path around lu_tiles: every pool bit for bit;
 14. the lusol entry point: lusol(1, A, b) on the same matrix (TpuLU ->
     SuperscanLU order 1; both LU kernels must launch), then lu_tiles at
     tol 0, 0.001 and 1 at every panel-LU key of that order-1 plan (as
     in 12, tol 1 to the kernels line; yardstick per shape and over the
     kernels line's lu_tiles shapes) and trsm_tiles_batched at
     every (H, W) of its trsm phases, in both of the LU's operand forms
     (U_D^T and the unit lower L_D; off the kernels line); on a mixed BTF
     matrix whose dense blocks factor on the card beside a sparse one,
     residuals <= 1e-14; a weak-diagonal matrix through lusol at tol 1
     and 0 (matching rescues both) and through SuperscanLU without
     matching (tol 1 solves, tol 0 is flagged); singular matrices give
     (False, None).

The line before the last is {"kernels": [...]} (launches counted in
phases 5, 8, 10, 13 and 14, errors and times measured in phases 3, 7, 12
and 14, each a sum over the main-path shapes checked; the v2 SELL slabs,
the LU tiles at tol 0 and 0.001 and the trsm kernel at the LU's shapes
are checked but left out; an SpMV bound
counts the bytes of the real entries, not the padding; chain_ms, beside
the bound, is the chain floor of a tile kernel, null for the others);
the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import time

import numpy as np
import scipy.sparse as sp
import torch

import tpusparse_torch
from tpusparse_torch.core import CSCMatrix
from tpusparse_torch.demo import resid_metric
from tpusparse_torch.device import solvers, superscan, superscan_lu
from tpusparse_torch.device.chol_plan import plan_cholesky
from tpusparse_torch.device.chol_tpu import TpuCholesky
from tpusparse_torch.device.kernels import (_build, bell_spmv, bell_spmv_ref,
                                            chol_tiles, chol_tiles_ref,
                                            dia_spmv, dia_spmv_ref,
                                            lu_tiles, lu_tiles_pool,
                                            lu_tiles_pool_ref, lu_tiles_ref,
                                            sell_spmv, sell_spmv_ref,
                                            trsm_tiles, trsm_tiles_batched,
                                            trsm_tiles_batched_ref,
                                            trsm_tiles_blocked_ref,
                                            trsm_tiles_ref)
from tpusparse_torch.device.kernels.sell_spmv import PACK
from tpusparse_torch.device.lu_tpu import TpuLU
from tpusparse_torch.device.supernodal import SupernodalCholesky
from tpusparse_torch.device.superscan import SuperscanCholesky
from tpusparse_torch.device.superscan_lu import SuperscanLU

# plan fields of the canonical cell (BENCH_r05) and of the g=48 grid, as
# the JAX planner produces them; plans are host-side, so any machine
# reproduces them exactly
CANON = dict(n=13824, nnz=93312, lnz=1874559, flops_true=969172461,
             flops_padded=1607240757, waste=0.397, occupancy=0.9968)
LARGE = dict(g=48, n=110592, lnz=52302620, flops_true=136423581398)
# the supernodal and fixed-tile plans of the g=24 grid, order 1
SUPERNODAL = dict(n=13824, lnz=1874559, flops_true=969172461,
                  flops_padded=14005883886, snodes=216, nlevels=87,
                  buckets=157)
TILED = dict(n=13824, lnz=1874559, flops_true=969172461,
             flops_padded=19631439800, B=128, nb=108, T=991)
# the LU leg of BENCH_r05 (bench.py::bench_lu_row): 3D convection-
# diffusion g=40 at order 0, max_segments 12; its panel-LU ("chol") and
# trsm phases, non-empty steps counted over the plan's segments
LU_CELL = dict(g=40, n=64000, nnz=438400, lnz=99966439,
               flops_true=158680853917, flops_padded=191099283584,
               waste=0.1696, segments=153)
LU_PHASES = dict(chol=909, trsm=2406)
UPDOWN_G = 12
UPDOWN_RESID = 1e-12
TOL = 1e-5          # kernel vs plain version, relative to max|plain|
RESID = 1e-14
DEV = "cuda"
HBM_BPS = 3.35e12   # H100 SXM: device memory bytes/s (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM: fp32 FLOP/s outside the tensor cores

KERNELS = {
    "chol_tiles": dict(fn=chol_tiles, ref=chol_tiles_ref,
                       source="tpusparse_torch/csrc/chol_tile.cu",
                       replaces="tpusparse/device/kernels/chol_tile.py:41"),
    "trsm_tiles_batched": dict(
        fn=trsm_tiles_batched, ref=trsm_tiles_batched_ref,
        blocked=trsm_tiles_blocked_ref,
        source="tpusparse_torch/csrc/trsm_tile.cu",
        replaces="tpusparse/device/kernels/trsm_tile.py:76"),
    "trsm_tiles": dict(fn=trsm_tiles, ref=trsm_tiles_ref,
                       blocked=trsm_tiles_blocked_ref,
                       source="tpusparse_torch/csrc/trsm_tile.cu",
                       replaces="tpusparse/device/kernels/trsm_tile.py:39"),
    "dia_spmv": dict(fn=dia_spmv, ref=dia_spmv_ref,
                     source="tpusparse_torch/csrc/dia_spmv.cu",
                     replaces="tpusparse/device/kernels/dia_spmv.py:40"),
    "sell_spmv": dict(fn=sell_spmv, ref=sell_spmv_ref,
                      source="tpusparse_torch/csrc/sell_spmv.cu",
                      replaces="tpusparse/device/kernels/sell_spmv.py:78"),
    "bell_spmv": dict(fn=bell_spmv, ref=bell_spmv_ref,
                      source="tpusparse_torch/csrc/bell_spmv.cu",
                      replaces="tpusparse/device/spmv.py:83"),
    # no Pallas counterpart: the JAX panel LU is XLA-fused jnp code
    "lu_tiles": dict(fn=lu_tiles, ref=lu_tiles_ref,
                     source="tpusparse_torch/csrc/lu_tile.cu",
                     replaces="tpusparse/device/superscan_lu.py:104"),
}
STATS = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                    bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, chain_ms=0.0)
         for name in KERNELS}
SELL_READ_MAX = 1.15    # bytes the SELL kernel reads / bytes needed


def log(msg: str) -> None:
    print(msg, flush=True)


def _csc(S) -> CSCMatrix:
    S = S.tocsc()
    S.sort_indices()
    return CSCMatrix(S.shape[0], S.shape[1], S.indptr, S.indices, S.data)


def grid_spd_3d(g: int) -> CSCMatrix:
    """7-point Laplacian on a g^3 grid + I (as bench.py builds it)."""
    n = g * g * g
    ex = -np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0.0
    ey = -np.ones(n - g)
    ey[(np.arange(g, n) // g) % g == 0] = 0.0
    ez = -np.ones(n - g * g)
    A = sp.diags([7.0 * np.ones(n), ex, ex, ey, ey, ez, ez],
                 [0, 1, -1, g, -g, g * g, -g * g], format="csc")
    return _csc(A)


def grid_spd(g: int) -> CSCMatrix:
    """5-point Laplacian on a g x g grid + I (bench.py::grid_spd, the
    SpMV leg of BENCH_r05)."""
    n = g * g
    ex = -np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0.0
    ey = -np.ones(n - g)
    return _csc(sp.diags([5.0 * np.ones(n), ex, ex, ey, ey],
                         [0, 1, -1, g, -g], format="csc"))


def conv_diff_3d(g: int) -> CSCMatrix:
    """Unsymmetric 3D convection-diffusion, upwind convection term (as
    bench.py::conv_diff_3d builds it, the LU leg of BENCH_r05)."""
    n = g * g * g
    ex_lo = -1.4 * np.ones(n - 1)
    ex_hi = -0.6 * np.ones(n - 1)
    mask = np.arange(1, n) % g == 0
    ex_lo[mask] = 0.0
    ex_hi[mask] = 0.0
    ey = -np.ones(n - g)
    ey[((np.arange(g, n) // g) % g) == 0] = 0.0
    ez = -np.ones(n - g * g)
    return _csc(sp.diags([7.0 * np.ones(n), ex_hi, ex_lo, ey, ey, ez, ez],
                         [0, 1, -1, g, -g, g * g, -g * g], format="csc"))


def conv_diff_2d(g: int, weak=()) -> CSCMatrix:
    """Unsymmetric 2D convection-diffusion with a 1e-12 diagonal at the
    ``weak`` columns (tests/test_superscan_lu.py::_convdiff)."""
    n = g * g
    ex_lo = np.full(n - 1, -1.6)
    ex_lo[np.arange(1, n) % g == 0] = 0
    ex_hi = np.full(n - 1, -0.4)
    ex_hi[np.arange(1, n) % g == 0] = 0
    ey = -np.ones(n - g)
    A = sp.diags([4.0 * np.ones(n), ex_hi, ex_lo, ey, ey], [0, 1, -1, g, -g],
                 format="lil")
    for i in weak:
        A[i, i] = 1e-12
    return _csc(A)


def irregular_graph(n: int, k: int = 6, seed: int = 0) -> CSCMatrix:
    """k-NN graph on random points in the unit square, in random point
    order, symmetrised, + 10 I (bench/bench_spmv.py::irregular_graph)."""
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    _, idx = cKDTree(pts).query(pts, k=k + 1)
    rows = np.repeat(np.arange(n), k)
    cols = idx[:, 1:].reshape(-1)
    M = sp.coo_matrix((rng.normal(size=rows.size), (rows, cols)),
                      shape=(n, n)).tocsc()
    return _csc(M + M.T + sp.eye(n) * 10)


def ba_graph(n: int, m0: int = 4, seed: int = 0) -> CSCMatrix:
    """Barabasi-Albert preferential attachment, power-law degrees
    (bench/bench_spmv.py::ba_graph)."""
    rng = np.random.default_rng(seed)
    repeated = np.zeros(2 * m0 * n, np.int64)
    repeated[:m0] = np.arange(m0)
    rlen = m0
    rows = np.repeat(np.arange(m0, n), m0)
    cols = np.empty(m0 * (n - m0), np.int64)
    for e, v in enumerate(range(m0, n)):
        tg = (np.arange(m0) if v == m0 else
              repeated[rng.integers(0, rlen, size=m0)])
        cols[e * m0:(e + 1) * m0] = tg
        repeated[rlen:rlen + m0] = tg
        repeated[rlen + m0:rlen + 2 * m0] = v
        rlen += 2 * m0
    M = sp.coo_matrix((rng.normal(size=rows.size), (rows, cols)),
                      shape=(n, n)).tocsc()
    return _csc(M + M.T + sp.eye(n) * 10)


def block_matrix(g: int = 16, b: int = 128, seed: int = 0) -> CSCMatrix:
    """kron(pattern of the 2D 5-point stencil on a g x g grid, a dense
    b x b block) + 10 I: block-structured, every tile full."""
    n = g * g
    ex = np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0.0
    P = sp.diags([np.ones(n), ex, ex, np.ones(n - g), np.ones(n - g)],
                 [0, 1, -1, g, -g], format="csc")
    P.eliminate_zeros()
    B = np.random.default_rng(seed).normal(size=(b, b))
    return _csc(sp.kron(P, B, format="csc") + sp.eye(n * b) * 10)


def reset_launches() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def launches() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


def sync() -> None:
    torch.cuda.synchronize()


def host_s(fn, reps: int = 10) -> float:
    """Host seconds per call of ``reps`` back-to-back calls (the device
    work is queued, not waited for), after a warm-up."""
    for _ in range(3):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps
    sync()
    return t


def cuda_ms(fn, reps: int = 10, runs: int = 5, queued: bool = True) -> float:
    """Median over ``runs`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after a warm-up.  With ``queued`` the stream
    first sleeps for twice the host time of ``reps`` calls, so all of
    them are queued before the first starts and the events see device
    time only (a call that synchronises still pays its host time);
    without it, host launch time between calls counts too."""
    cycles = int(max(2 * reps * host_s(fn, reps), 1e-3) * 2e9)  # <= 2 GHz
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def bound_ms(nbytes: float, flops: float) -> tuple:
    """(least time on the card in ms, what bounds it): bytes over the
    device memory rate, operations over the fp32 rate."""
    tb, to = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def record(name: str, err: float, ms: float, pms: float, lms: float,
           nbytes: float, flops: float) -> float:
    """Adds one checked shape to the kernel's sums; returns its bound."""
    s = STATS[name]
    b, _ = bound_ms(nbytes, flops)
    s["max_abs_err"] = max(s["max_abs_err"], err)
    s["ms"] += ms
    s["plain_ms"] += pms
    s["library_ms"] += lms
    s["bound_ms"] += b
    s["bytes_ms"] += nbytes / HBM_BPS * 1e3
    s["ops_ms"] += flops / FP32_FLOPS * 1e3
    return b


def yardstick(name: str, label: str, ms: float, lib_ms: float) -> None:
    """Raises if the kernel took longer than the library call that
    computes the same function, timed in the same run."""
    if not ms <= lib_ms:
        raise AssertionError(f"{name} {label}: kernel {ms:.4f} ms is slower "
                             f"than the library call, {lib_ms:.4f} ms")


def rel_err(out: torch.Tensor, ref: torch.Tensor, what: str) -> tuple:
    """(max abs error, the same over max|ref|); raises above TOL."""
    sync()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if not rel <= TOL:
        raise AssertionError(f"{what}: rel err {rel:.3e}")
    return err, rel


def check_plan(plan, A, want, **extra) -> None:
    """Raises unless every field of ``want`` that the plan has (or that
    ``extra`` gives) equals it."""
    got = dict(n=plan.n, nnz=int(A.indptr[-1]), lnz=plan.lnz,
               flops_true=plan.flops_true, flops_padded=plan.flops_padded,
               waste=round(plan.waste_ratio, 4), **extra)
    if hasattr(plan, "slot_occupancy"):
        got["occupancy"] = round(plan.slot_occupancy, 4)
    for k, v in want.items():
        if k in got and got[k] != v:
            raise AssertionError(f"plan field {k}: {got[k]} != {v}")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi.splitlines()[0])
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds else 0:.2f}"
        f" s, one process per source) -> {_build._target()}")
    with open(_build._target() + ".log") as f:      # ptxas -v, per kernel
        said = f.read().replace("ptxas info    : ", "").splitlines()
    lu, spills = 0, []
    for i, line in enumerate(said[:-2]):
        if line.startswith("Function properties for"):
            log(f"[2] ...{line.split()[-1][-44:]}: {said[i + 2].strip()}; "
                f"{said[i + 1].strip()}")
            if "lu_tile_kernel" in line:
                lu += 1
                if not said[i + 1].strip().startswith(
                        "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                        "spill loads"):
                    spills.append(line.split()[-1])
    if lu != 16 or spills:
        raise AssertionError(f"{lu} lu_tile_kernel instances (want 16), "
                             f"with local memory: {spills}")


def _tile_shapes(plan):
    """{W: batch} of the chol keys, {(H, W): batch} of the trsm keys, at
    the largest per-step batch over the plan's segments."""
    chol, trsm = {}, {}
    for seg in plan.segments:
        for key, arrs in seg.xs.items():
            bs = next(iter(arrs.values())).shape[1]
            if key[0] == "chol":
                chol[key[2]] = max(chol.get(key[2], 0), bs)
            elif key[0] == "trsm":
                hw = (key[2], key[3])
                trsm[hw] = max(trsm.get(hw, 0), bs)
    return chol, trsm


def _spd(rng, nt: int, B: int) -> torch.Tensor:
    X = torch.from_numpy(rng.normal(size=(nt, B, B)).astype(np.float32))
    X = X.to(DEV)
    return X @ X.mT + B * torch.eye(B, device=DEV)


def chain_step_ms(kind: int, steps: int = 1 << 16,
                  entry: str = "tpt_chain_probe") -> float:
    """Milliseconds of one dependent step on one warp (``entry``, by
    default tpt_chain_probe: kind 0 a Cholesky column (reciprocal,
    multiply, fused multiply-add), kind 1 the substitution column of the
    trsm kernel (fused multiply-add, multiply by the diagonal's
    reciprocal))."""
    probe_fn = getattr(_build.library(), entry)
    out = torch.empty(32, device=DEV)

    def probe():
        _build.check(probe_fn(out.data_ptr(), steps, kind,
                              torch.cuda.current_stream().cuda_stream), entry)
    return cuda_ms(probe, reps=3, runs=3) / steps


def compare_tiles(name: str, args: tuple, lib, nbytes: float, flops: float,
                  chain: float, label: str, tally: bool = True,
                  phase: str = "3") -> tuple:
    """One shape of a tile kernel against its plain version, with the
    times of kernel, plain version and library call; returns (kernel ms,
    library ms).  ``chain`` is the shape's chain floor in ms.  With
    ``tally`` false the shape is checked and printed but not added to the
    kernels line.  A kernel with a ``blocked`` plain version (its own
    arithmetic in torch ops) is held against that one too, and it is the
    plain version timed: the other is the library call itself."""
    k = KERNELS[name]
    out = k["fn"](*args)
    err, rel = rel_err(out, k["ref"](*args), f"{name} {label}")
    ms = cuda_ms(lambda: k["fn"](*args))
    if "blocked" in k:
        rel_err(out, k["blocked"](*args), f"{name} {label} (blocked plain)")
        pms = cuda_ms(lambda: k["blocked"](*args), reps=3, runs=3)
    else:
        pms = cuda_ms(lambda: k["ref"](*args))
    lms = cuda_ms(lib)
    if tally:
        b = record(name, err, ms, pms, lms, nbytes, flops)
        STATS[name]["chain_ms"] += chain
    else:
        b, _ = bound_ms(nbytes, flops)
    log(f"[{phase}] {name} {label}: max_abs_err {err:.3e} (rel {rel:.1e}), "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms, library {lms:.4f} ms, "
        f"bound {b:.4f} ms, chain floor {chain:.4f} ms")
    return ms, lms


def chol_shape(rng, W: int, nt: int, step: float, label: str,
               tally: bool = True) -> None:
    A = _spd(rng, nt, W)
    ms, lms = compare_tiles(
        "chol_tiles", (A,), lambda: torch.linalg.cholesky_ex(A),
        2 * nt * W * W * 4, nt * W ** 3 / 3, W * step, label, tally)
    yardstick("chol_tiles", label, ms, lms)


def chol_nan_contract(rng, B: int, nt: int, bad: int) -> None:
    """Tile ``bad`` of ``nt`` is not SPD: it must come out non-finite and
    the tiles around it as the plain version gives them."""
    A = _spd(rng, nt, B)
    A[bad, B // 2, B // 2] = -A[bad, B // 2, B // 2]
    L, R = chol_tiles(A), chol_tiles_ref(A)
    sync()
    good = [t for t in range(nt) if t != bad]
    if torch.isfinite(L[bad]).all() or not torch.isfinite(L[good]).all():
        raise AssertionError(f"chol_tiles B={B}: NaN contract broken")
    if not torch.allclose(L[good], R[good], rtol=0,
                          atol=TOL * R[good].abs().max().item()):
        raise AssertionError(f"chol_tiles B={B}: SPD tiles next to a bad "
                             f"one")
    log(f"[3] chol_tiles NaN contract B={B}: tile {bad} of {nt} is "
        f"non-finite, the others agree")


def trsm_shape(rng, name: str, nt: int, R: int, W: int, step: float,
               label: str, tally: bool = True) -> None:
    """One (nt, R, W) of ``trsm_tiles_batched`` or ``trsm_tiles`` (one
    shared L) on well-conditioned factors: against both plain versions,
    timed, and held to solve_triangular's time.  The bytes behind the
    bound count the lower triangle of each factor, which is all the
    function reads."""
    shared = name == "trsm_tiles"
    L = chol_tiles_ref(_spd(rng, 1 if shared else nt, W))
    L = L[0] if shared else L
    X = torch.from_numpy(rng.normal(size=(nt, R, W)).astype(
        np.float32)).to(DEV)
    U = L.mT.expand(nt, -1, -1) if shared else L.mT
    ms, lms = compare_tiles(
        name, (L, X),
        lambda: torch.linalg.solve_triangular(U, X, upper=True, left=False),
        4 * ((1 if shared else nt) * W * (W + 1) // 2 + 2 * X.numel()),
        nt * R * W * W, W * step, label, tally)
    yardstick(name, label, ms, lms)


def trsm_nan_contract(rng, nt: int, R: int, W: int, bad: int) -> None:
    """Slot ``bad`` of ``nt`` is not finite (its L all NaN in the per-slot
    form, as a failed chol tile leaves it; its X all NaN where one L is
    shared): it must come out non-finite and the slots around it as the
    plain version gives them."""
    L = chol_tiles_ref(_spd(rng, nt, W))
    X = torch.from_numpy(rng.normal(size=(nt, R, W)).astype(
        np.float32)).to(DEV)
    Lb, Xb = L.clone(), X.clone()
    Lb[bad] = float("nan")
    Xb[bad] = float("nan")
    good = [t for t in range(nt) if t != bad]
    for what, Y, ref in (
            ("trsm_tiles_batched", trsm_tiles_batched(Lb, X),
             trsm_tiles_batched_ref(L, X)),
            ("trsm_tiles", trsm_tiles(L[0], Xb), trsm_tiles_ref(L[0], X))):
        sync()
        if torch.isfinite(Y[bad]).any() or not torch.isfinite(Y[good]).all():
            raise AssertionError(f"{what} W={W}: NaN contract broken")
        if not torch.allclose(Y[good], ref[good], rtol=0,
                              atol=TOL * ref[good].abs().max().item()):
            raise AssertionError(f"{what} W={W}: slots next to a bad one")
    log(f"[3] trsm NaN contract R={R} W={W}: slot {bad} of {nt} is "
        f"non-finite, the others agree (per-slot L and shared L)")


def phase_kernels(plan) -> tuple:
    """Returns the probe's (Cholesky, substitution) step latencies."""
    rng = np.random.default_rng(0)
    step_chol, step_trsm = chain_step_ms(0), chain_step_ms(1)
    log(f"[3] one dependent step on one warp: Cholesky column "
        f"{step_chol * 1e6:.1f} ns, substitution column "
        f"{step_trsm * 1e6:.1f} ns (chain floor of a tile kernel = its "
        f"width times its step)")

    chol, trsm = _tile_shapes(plan)
    for W, nt in sorted(chol.items()):
        chol_shape(rng, W, nt, step_chol, f"W={W} nt={nt}"
                   + (" (the fixed-tile path's panel)" if (W, nt) == (128, 1)
                      else ""))
    for (H, W), nt in sorted(trsm.items()):
        trsm_shape(rng, "trsm_tiles_batched", nt, H, W, step_trsm,
                   f"H={H} W={W} nt={nt}")
    s = STATS["trsm_tiles_batched"]
    yardstick("trsm_tiles_batched", f"sum over the {len(trsm)} shapes",
              s["ms"], s["library_ms"])

    # the shared-L trsm of the fixed-tile engine at every panel height of
    # the g=24 plan (B = 128)
    tplan = plan_cholesky(grid_spd_3d(24), order=1)
    W = tplan.B
    heights = sorted({x.size for x in tplan.off_ids} - {0})
    for r in heights:
        trsm_shape(rng, "trsm_tiles", r, W, W, step_trsm,
                   f"nt={r} R={W} W={W}")
    s = STATS["trsm_tiles"]
    yardstick("trsm_tiles", f"sum over the {len(heights)} shapes", s["ms"],
              s["library_ms"])

    # widths that the plans do not produce but the wrappers take
    trsm_shape(rng, "trsm_tiles_batched", 5, 40, 24, step_trsm,
               "H=40 W=24 nt=5 (off the plans)", tally=False)
    trsm_shape(rng, "trsm_tiles", 3, 8, 120, step_trsm,
               "nt=3 R=8 W=120 (off the plans)", tally=False)

    # a bad tile between good ones: in a block of its own (B=128), and
    # sharing a block with three others (B=16 and 8: four tiles a block)
    chol_nan_contract(rng, 16, 4, 2)
    chol_nan_contract(rng, 128, 3, 1)
    chol_nan_contract(rng, 8, 11, 5)
    # the same for trsm: slots that share a block (W=8), and a slot spread
    # over blocks (W=128)
    trsm_nan_contract(rng, 11, 8, 8, 5)
    trsm_nan_contract(rng, 3, 128, 128, 1)
    return step_chol, step_trsm


def phase_kernels_large(plan, step_chol: float, step_trsm: float) -> None:
    """The chol and per-slot trsm kernels at the largest per-step batch of
    every W and (H, W) of ``plan`` (the g=48 plan): checked, timed and
    held to the yardsticks, but not added to the kernels line, whose sums
    stay those of the canonical plan's shapes."""
    rng = np.random.default_rng(10)
    chol, trsm = _tile_shapes(plan)
    for W, nt in sorted(chol.items()):
        chol_shape(rng, W, nt, step_chol, f"g=48 W={W} nt={nt}", tally=False)
    for (H, W), nt in sorted(trsm.items()):
        trsm_shape(rng, "trsm_tiles_batched", nt, H, W, step_trsm,
                   f"g=48 H={H} W={W} nt={nt}", tally=False)


def phase_canonical(F: SuperscanCholesky, A: CSCMatrix, t_plan: float):
    check_plan(F.plan, A, CANON)
    reset_launches()
    t0 = time.perf_counter()
    if not F.factor():
        raise AssertionError("canonical factor failed")
    t_first = time.perf_counter() - t0
    n_first = launches()
    if not (n_first["chol_tiles"] > 0 and n_first["trsm_tiles_batched"] > 0):
        raise AssertionError(f"canonical factor skipped a kernel: {n_first}")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        assert F.factor()
        warm.append(time.perf_counter() - t0)
    t_warm = min(warm)
    b = np.random.default_rng(1).normal(size=A.n)
    F._solve_f32(b)                                 # uploads the schedule
    t0 = time.perf_counter()
    F._solve_f32(b)
    t_solve32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = F.solve(b)
    t_solve = time.perf_counter() - t0
    r = resid_metric(F.A, x, b)
    if not (np.all(np.isfinite(x)) and x.shape == (A.n,) and r <= RESID):
        raise AssertionError(f"canonical residual {r:.3e}")
    log(f"[4] canonical g=24 n={A.n}: plan {t_plan:.3f} s, factor first "
        f"{t_first * 1e3:.1f} ms, warm {t_warm * 1e3:.1f} ms "
        f"({F.plan.flops_true / t_warm / 1e9:.2f} GFLOP/s true), f32 solve "
        f"{t_solve32 * 1e3:.1f} ms, refined solve {t_solve * 1e3:.1f} ms, "
        f"residual {r:.3e}, launches in first factor {n_first}")


def _timed(cls):
    """A subclass of the engine ``cls`` that records the plan / factor /
    solve wall times of the factor object cholsol makes (sync: factor
    ends on its finiteness check, solve on its download)."""
    class Timed(cls):
        def __init__(self, *a, **kw):
            t0 = time.perf_counter()
            super().__init__(*a, **kw)
            self.t = {"plan": time.perf_counter() - t0, "factor": []}
            made.append(self)

        def factor(self):
            t0 = time.perf_counter()
            ok = super().factor()
            self.t["factor"].append(time.perf_counter() - t0)
            return ok

        def solve(self, b, refine_iters=3):
            t0 = time.perf_counter()
            x = super().solve(b, refine_iters)
            self.t["solve"] = time.perf_counter() - t0
            return x

    made = []
    Timed.made = made
    return Timed


ENGINES = {"SuperscanCholesky": SuperscanCholesky,
           "SupernodalCholesky": SupernodalCholesky,
           "TpuCholesky": TpuCholesky}


def timed_cholsol(A: CSCMatrix, b: np.ndarray, **kw) -> tuple:
    """tpusparse_torch.cholsol(1, A, b, device=DEV, **kw) with the launch
    counters reset just before it and every engine timed: returns (the
    one factor object it made, x, launches, wall s)."""
    timed = {name: _timed(cls) for name, cls in ENGINES.items()}
    for name, cls in timed.items():
        setattr(solvers, name, cls)
    try:
        reset_launches()
        t0 = time.perf_counter()
        ok, x = tpusparse_torch.cholsol(1, A, b, device=DEV, **kw)
        sync()
        t_all = time.perf_counter() - t0
        counts = launches()
    finally:
        for name, cls in ENGINES.items():
            setattr(solvers, name, cls)
    made = [F for cls in timed.values() for F in cls.made]
    if len(made) != 1:
        raise AssertionError(f"cholsol made {len(made)} factor objects")
    if not ok:
        raise AssertionError(f"cholsol n={A.n} {kw} returned ok=False")
    return made[0], x, counts, t_all


def phase_large() -> tuple:
    g = LARGE["g"]
    A = grid_spd_3d(g)
    b = np.random.default_rng(2).normal(size=A.n)
    F, x, counts, t_all = timed_cholsol(A, b)
    if not isinstance(F, SuperscanCholesky):
        raise AssertionError(f"auto chose {type(F).__mro__[1].__name__}")
    if not (counts["chol_tiles"] > 0 and counts["trsm_tiles_batched"] > 0):
        raise AssertionError(f"cholsol skipped a kernel: {counts}")
    check_plan(F.plan, A, {k: LARGE[k] for k in ("n", "lnz",
                                                  "flops_true")})
    r = resid_metric(A, x, b)
    if not (np.all(np.isfinite(x)) and x.shape == (A.n,) and r <= RESID):
        raise AssertionError(f"g=48 residual {r:.3e}")
    t_f = F.t["factor"][0]
    log(f"[5] cholsol g={g} n={A.n}: plan {F.t['plan']:.2f} s, factor "
        f"{t_f:.3f} s "
        f"({F.plan.flops_true / t_f / 1e9:.2f} GFLOP/s true), "
        f"refined solve {F.t['solve']:.3f} s, total {t_all:.2f} s, "
        f"residual {r:.3e}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {counts}")
    return counts, F.plan


def phase_failure() -> None:
    d = np.eye(8)
    d[4, 4] = -1.0
    A = _csc(sp.csc_matrix(d + 0.01 * np.ones((8, 8))))
    for F in (SuperscanCholesky(A, order=0, wmax=8, device=DEV),
              SupernodalCholesky(A, order=0, device=DEV),
              TpuCholesky(A, order=0, block=8, device=DEV)):
        if F.factor() is not False:
            raise AssertionError(f"{type(F).__name__}: non-SPD matrix "
                                 f"factored")
    log("[6] failure contract: non-SPD 8x8 -> factor() False in the "
        "superscan, supernodal and fixed-tile engines")


def warm_factor_s(F) -> float:
    """Best of three further factor() calls, in seconds."""
    for _ in range(3):
        if not F.factor():
            raise AssertionError(f"{type(F).__name__}: warm factor failed")
    return min(F.t["factor"][1:])


def check_solution(label: str, A: CSCMatrix, x, b, tol: float) -> float:
    r = resid_metric(A, x, b)
    if not (np.all(np.isfinite(x)) and x.shape == (A.n,) and r <= tol):
        raise AssertionError(f"{label}: residual {r:.3e}")
    return r


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _profile_summary(prof, wall: float, named: dict = None) -> str:
    """The device kernels of a profiled window (count, summed time; one
    stream, so they do not overlap) against its wall time in s, the
    three kernels that took longest and, for each {label: substring of a
    kernel's name} of ``named``, the launches and time of those kernels."""
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        return "device time not measured (the profiler recorded none)"
    busy_ms = sum(r[0] for r in rows) / 1e3
    top = "; ".join(f"{k[:60]} x{c} {t / 1e3:.2f} ms" for t, c, k in rows[:3])
    split = "".join(
        f"; {label} x{sum(c for _, c, k in rows if sub in k)} "
        f"{sum(t for t, _, k in rows if sub in k) / 1e3:.2f} ms"
        for label, sub in (named or {}).items())
    return (f"{sum(r[1] for r in rows)} device ops, {busy_ms:.2f} ms of "
            f"kernel time in a {wall * 1e3:.1f} ms profiled wall (busy "
            f"{busy_ms / (wall * 1e3):.3f}); top: {top}{split}")


def device_profile(fn) -> str:
    """One fn() under torch.profiler, summed by _profile_summary."""
    sync()
    with _profiler() as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return _profile_summary(prof, wall)


def fresh_memory() -> float:
    """Frees what earlier phases left (reference cycles included) and
    restarts the peak count; returns the MiB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**20


def engine_line(label: str, F, r: float, t_all: float, counts,
                base: float) -> None:
    t_f = F.t["factor"]
    log(f"[{label}] plan {F.t['plan']:.3f} s, factor first "
        f"{t_f[0] * 1e3:.1f} ms, warm {min(t_f[1:]) * 1e3:.1f} ms "
        f"({F.plan.flops_true / min(t_f[1:]) / 1e9:.2f} GFLOP/s true), "
        f"refined solve {F.t['solve'] * 1e3:.1f} ms, cholsol total "
        f"{t_all:.2f} s, residual {r:.3e}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB (of it "
        f"{base:.0f} MiB held before the phase), launches {counts}")


def phase_supernodal() -> None:
    A = grid_spd_3d(24)
    b = np.random.default_rng(5).normal(size=A.n)
    base = fresh_memory()
    F, x, counts, t_all = timed_cholsol(A, b)
    if not isinstance(F, SupernodalCholesky):
        raise AssertionError(f"auto chose {type(F).__mro__[1].__name__} "
                             f"at n={A.n}")
    p = F.plan
    check_plan(p, A, SUPERNODAL, snodes=len(p.snodes), nlevels=p.nlevels,
               buckets=len(p.buckets))
    if any(counts.values()):
        raise AssertionError(f"supernodal launched a kernel: {counts}")
    r = check_solution("supernodal g=24", A, x, b, RESID)
    warm_factor_s(F)
    widths = sorted({W for _, W in p.buckets})
    log(f"[9] cholsol auto g=24 n={A.n} -> SupernodalCholesky: "
        f"{len(p.snodes)} supernodes, {p.nlevels} levels, "
        f"{len(p.buckets)} buckets (widths {widths}), flops_padded "
        f"{p.flops_padded}")
    engine_line("9", F, r, t_all, counts, base)
    log(f"[9] warm factor profiled: {device_profile(F.factor)}")


def phase_tiled() -> dict:
    A = grid_spd_3d(24)
    b = np.random.default_rng(6).normal(size=A.n)
    base = fresh_memory()
    F, x, counts, t_all = timed_cholsol(A, b, engine="tiled")
    if not isinstance(F, TpuCholesky):
        raise AssertionError(f"engine tiled made "
                             f"{type(F).__mro__[1].__name__}")
    p = F.plan
    check_plan(p, A, TILED, B=p.B, nb=p.nb, T=p.pool_init.shape[0])
    if not (counts["chol_tiles"] > 0 and counts["trsm_tiles"] > 0):
        raise AssertionError(f"tiled cholsol skipped a kernel: {counts}")
    r = check_solution("tiled g=24", A, x, b, RESID)
    warm_factor_s(F)
    log(f"[10] cholsol tiled g=24 n={A.n}: B {p.B}, nb {p.nb}, T "
        f"{p.pool_init.shape[0]}, flops_padded {p.flops_padded}")
    engine_line("10", F, r, t_all, counts, base)
    log(f"[10] warm factor profiled: {device_profile(F.factor)}")
    return counts


def phase_updown() -> None:
    g = UPDOWN_G
    A = grid_spd_3d(g)
    n = A.n
    rng = np.random.default_rng(1)
    b = rng.normal(size=n)
    t0 = time.perf_counter()
    F = TpuCholesky(A, order=1, device=DEV)
    if not F.factor():
        raise AssertionError("updown: factor failed")
    t_factor = time.perf_counter() - t0
    # demo3's recipe: w on the pattern of column n/2 of L, in original
    # coordinates
    L, _ = F._extract_L()
    k = n // 2
    seg = L.indices[L.indptr[k]:L.indptr[k + 1]]
    wperm = np.zeros(n)
    wperm[seg] = rng.random(seg.size)
    w = np.zeros(n)
    w[F.plan.perm] = wperm
    S = A.toscipy()
    ts, rs = [], []
    for sigma, target in ((+1, S + sp.csc_matrix(np.outer(w, w))), (-1, S)):
        t0 = time.perf_counter()
        if not F.updown(sigma, w):
            raise AssertionError(f"updown({sigma:+d}) returned False")
        ts.append(time.perf_counter() - t0)
        if not F.pool.is_cuda:
            raise AssertionError("updown: the pool left the card")
        x = F.solve(b)
        rs.append(check_solution(f"updown({sigma:+d})", _csc(target), x, b,
                                 UPDOWN_RESID))
    log(f"[11] updown g={g} n={n} (B {F.plan.B}, nb {F.plan.nb}, "
        f"{seg.size} entries in w): plan + factor {t_factor:.2f} s, "
        f"update {ts[0]:.3f} s, downdate {ts[1]:.3f} s "
        f"({min(ts) / n * 1e6:.1f} us per column), residuals "
        f"{rs[0]:.3e} / {rs[1]:.3e}, pool on {F.pool.device}")

    def pair():
        F.updown(+1, w)
        F.updown(-1, w)
    log(f"[11] update + downdate profiled: {device_profile(pair)}")


# ----------------------------------------------------------- LU
def _swapped_tiles(rng, nt: int, W: int) -> np.ndarray:
    """Diagonally dominant tiles with rows 0 and 1 and W/8 more disjoint
    pairs of adjacent rows (k, k + 1) swapped, where row k had no entry
    left of the diagonal and row k + 1 none left of its own: column k
    meets an exact zero on the diagonal, and every tol > 0 pivots."""
    M = rng.normal(size=(nt, W, W)) + 4 * np.sqrt(W) * np.eye(W)
    for t in range(nt):
        for k in [0, *rng.choice(np.arange(2, W - 1, 2), size=max(1, W // 8),
                                 replace=False)]:
            M[t, k, :k] = 0.0
            M[t, k + 1, :k + 1] = 0.0
            M[t, [k, k + 1]] = M[t, [k + 1, k]]
    return M


def _lu_tiles_input(rng, nt: int, W: int, tol: float) -> torch.Tensor:
    """tol 0: diagonally dominant tiles (stable without pivoting);
    0.001: the swapped tiles; 1.0: random normal tiles."""
    if tol == 0.0:
        D = rng.normal(size=(nt, W, W)) + W * np.eye(W)
    elif tol < 1.0:
        D = _swapped_tiles(rng, nt, W)
    else:
        D = rng.normal(size=(nt, W, W))
    return torch.from_numpy(D.astype(np.float32)).to(DEV)


def _tie_tiles(rng, nt: int, W: int, tol: float) -> torch.Tensor:
    """Tiles on which every step of the pivoted LU is exact in f32 (each
    product has a power of two or +-1 for a factor), built as
    tests/test_torch_kernels.py::_tie_tiles builds them: the rows of an
    upper triangular T (power-of-two diagonal, entries 0, +-1, +-2, +-4
    above it) in a random order, so that earlier swaps move many rows; at
    columns k = 1, 5, 9, ... two candidates of equal |value| (rows T[k]
    and +-T[k] + T[k + 1]); at column W - 3 the diagonal exactly f32(tol)
    times the other candidate's |value| (equal to it at tol >= 1)."""
    M = np.zeros((nt, W, W), np.float32)
    for t in range(nt):
        T = np.triu(rng.choice([0.0, 0.0, 1.0, -1.0, 2.0, -2.0, 4.0, -4.0],
                               size=(W, W)), 1)
        T += np.diag(2.0 ** rng.integers(0, 4, size=W))
        rows = T.copy()
        for k in range(1, W - 1, 4):
            rows[k + 1] = rng.choice([1.0, -1.0]) * T[k] + T[k + 1]
        kb = W - 3
        big = 2.0 ** rng.integers(0, 4)
        rows[kb, kb] = (np.float32(tol) * np.float32(big) if tol < 1.0
                        else big)
        rows[kb, kb + 1:] = 0.0
        rows[kb + 1] = T[kb + 1]
        rows[kb + 1, kb] = -big
        order = np.concatenate([rng.permutation(kb), [kb],
                                kb + 1 + rng.permutation(W - kb - 1)])
        M[t] = rows[order]
    return torch.from_numpy(M).to(DEV)


def _eps(D: torch.Tensor) -> float:
    """The pivot floor SuperscanLU.factor passes: f32(1e-8 max|A|)."""
    return float(np.float32(1e-8 * D.abs().max().item()))


def lu_bit_equal(D: torch.Tensor, eps: float, tol: float,
                 label: str) -> tuple:
    """lu_tiles against lu_tiles_ref on D: raises unless F is bit for bit
    the plain version's and P identical; returns (P, max |F - plain|)."""
    F, P = lu_tiles(D, eps, tol)
    Fr, Pr = lu_tiles_ref(D, eps, tol)
    err = (F - Fr).abs().max().item()
    if not torch.equal(P, Pr):
        raise AssertionError(f"lu_tiles {label}: pivots differ")
    if not torch.equal(F, Fr):
        raise AssertionError(f"lu_tiles {label}: F differs from the plain "
                             f"version by {err:.3e}")
    return P, err


LU_STEP = {}    # {probe kind: ms of one LU column on one warp}


def lu_chain_step() -> float:
    """Milliseconds of one dependent LU column as lu_tiles chains it
    (tpt_lu_chain_probe kind 2, redux.sync search), measured once a run;
    kind 3, the same column with a butterfly of shuffles, is printed
    beside it."""
    if not LU_STEP:
        LU_STEP.update({k: chain_step_ms(k, entry="tpt_lu_chain_probe")
                        for k in (2, 3)})
        log(f"[12] one dependent LU column on one warp: {LU_STEP[2] * 1e6:.1f}"
            f" ns with redux.sync (lu_tiles' search), {LU_STEP[3] * 1e6:.1f}"
            f" ns with a butterfly of shuffles (chain floor of lu_tiles = W "
            f"times the first)")
    return LU_STEP[2]


def lu_launch_floor_ms(nt: int, W: int) -> float:
    """Device time of an empty kernel on the grid lu_tiles takes for nt
    tiles of width W (tpt_lu_empty)."""
    lib = _build.library()

    def empty():
        _build.check(lib.tpt_lu_empty(
            nt, W, torch.cuda.current_stream().cuda_stream), "tpt_lu_empty")
    return cuda_ms(empty)


def _panel_steps(plan) -> dict:
    """{(pw, W): (real slots, padded slots)} of each panel-LU key's
    largest step over the plan's segments (of equal ones, one with a real
    tile and, of those, the most padded slots: the most slots that share
    the pad block), read from the step's own dbase.  Raises
    unless every step's real slots are distinct and its padded slots,
    all on the pad block (plan.pool_rows[pw]), stand together after
    them: lu_tiles_pool's condition for slots that share a tile."""
    def rank(nreal, npad):
        return nreal + npad, nreal > 0, npad

    out = {}
    for seg in plan.segments:
        for key, arrs in seg.xs.items():
            if key[0] != "chol":
                continue
            _, pw, W = key
            lad, pad = seg.ladders.get(key), plan.pool_rows[pw]
            for step in range(seg.hi - seg.lo):
                bs = (arrs["dbase"].shape[1] if lad is None
                      else lad[int(seg.lvls[key][step])])
                d = np.asarray(arrs["dbase"][step, :bs])
                nreal = int((d != pad).sum())
                if not ((d[nreal:] == pad).all()
                        and np.unique(d[:nreal]).size == nreal):
                    raise AssertionError(f"panel step {key} {step}: padded "
                                         f"slots not together at the end")
                if rank(nreal, bs - nreal) > rank(*out.get((pw, W), (0, 0))):
                    out[(pw, W)] = (nreal, bs - nreal)
    return out


def _step_pools(rng, W: int, pw: int, nreal: int, npad: int,
                tol: float) -> tuple:
    """The L and U pools of a panel-LU step with nreal tiles and npad
    padded slots, as the planner lays them out but compacted: the real
    tiles (_lu_tiles_input) in slot order, each followed by 8 rows that
    no tile owns, then the pw-row identity pad block that the padded
    slots share, then W more rows; junk everywhere else, columns W.. of
    the tile rows and all of U included (the entry must zero or overwrite
    what it owns and touch nothing more).  Returns (L, U, dbase, D): D
    the (nreal + npad, W, W) tiles the slots read, gathered."""
    stride = W + 8
    rows = nreal * stride + pw + W
    L = torch.from_numpy(rng.normal(size=(rows, pw)).astype(np.float32))
    U = torch.from_numpy(rng.normal(size=(rows, pw)).astype(np.float32))
    L, U = L.to(DEV), U.to(DEV)
    dbase = torch.cat([torch.arange(nreal) * stride,
                       torch.full((npad,), nreal * stride)]).to(DEV)
    idx = dbase[:, None] + torch.arange(W, device=DEV)
    L[:, :W][idx[:nreal]] = _lu_tiles_input(rng, nreal, W, tol)
    L[nreal * stride:nreal * stride + pw] = torch.eye(pw, device=DEV)
    return L, U, dbase, L[:, :W][idx]


def lu_pool_bit_equal(L, U, dbase, W: int, eps: float, tol: float,
                      label: str) -> tuple:
    """lu_tiles_pool against lu_tiles_pool_ref on copies of the pools L
    and U: raises unless both pools come out bit for bit the same;
    returns the kernel's (L, U)."""
    L1, U1, L2, U2 = L.clone(), U.clone(), L.clone(), U.clone()
    lu_tiles_pool(L1, U1, dbase, W, eps, tol)
    lu_tiles_pool_ref(L2, U2, dbase, W, eps, tol)
    sync()
    if not (torch.equal(L1, L2) and torch.equal(U1, U2)):
        raise AssertionError(f"lu_tiles_pool {label}: pools differ from the "
                             f"plain version")
    return L1, U1


def lu_shape(rng, pw: int, W: int, nreal: int, npad: int, tol: float,
             tally: bool, phase: str = "12",
             plan: str = "g=40 order 0") -> None:
    """One panel-LU step at one tol, through the entry the factor calls
    (lu_tiles_pool, in place on the step's pools) against its plain
    version, both pools bit for bit, and through lu_tiles on the same
    tiles gathered (F bit for bit, P identical); lu_tiles_pool timed,
    in place on its own output (the kernel's time does not depend on
    the values), beside its plain version, lu_factor_ex on the gathered
    tiles and an empty launch of the same grid, and held to
    lu_factor_ex's time.  The bound counts the distinct tiles (the real
    ones and one pad block): W^2 floats read, W pw floats of F and of P
    written, (2/3) W^3 flops each; the chain floor is W LU columns on
    one warp."""
    nt = nreal + npad
    label = f"{plan} pw={pw} W={W} nt={nt} ({npad} padded) tol={tol}"
    L, U, dbase, D = _step_pools(rng, W, pw, nreal, npad, tol)
    eps = _eps(D)
    P, err = lu_bit_equal(D, eps, tol, label)
    eye = torch.eye(W, device=DEV)
    if tol == 0.0 and not torch.equal(P, eye.expand_as(P)):
        raise AssertionError(f"lu_tiles {label}: P is not I")
    if tol > 0.0 and nreal and torch.equal(P, eye.expand_as(P)):
        raise AssertionError(f"lu_tiles {label}: no pivoting took place")
    L1, U1 = lu_pool_bit_equal(L, U, dbase, W, eps, tol, label)
    ms = cuda_ms(lambda: lu_tiles_pool(L1, U1, dbase, W, eps, tol))
    pms = cuda_ms(lambda: lu_tiles_pool_ref(L, U, dbase, W, eps, tol),
                  reps=3, runs=3)
    lms = cuda_ms(lambda: torch.linalg.lu_factor_ex(D))
    floor = lu_launch_floor_ms(nt, W)
    chain = W * lu_chain_step()
    tiles = nreal + (npad > 0)
    nbytes, flops = 4 * tiles * (W * W + 2 * W * pw), 2 * tiles * W ** 3 / 3
    if tally:
        b = record("lu_tiles", err, ms, pms, lms, nbytes, flops)
        STATS["lu_tiles"]["chain_ms"] += chain
    else:
        b, _ = bound_ms(nbytes, flops)
    log(f"[{phase}] lu_tiles {label}: bit-equal in the pools and gathered "
        f"(max_abs_err {err:.1e}), kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"lu_factor_ex {lms:.4f} ms, bound {b:.5f} ms, chain floor "
        f"{chain:.4f} ms, launch floor {floor:.4f} ms"
        f"{'' if tally else ' (off the main path: not in the kernels line)'}")
    yardstick("lu_tiles", label, ms, lms)


def lu_ties(rng, W: int, tol: float) -> None:
    """lu_tiles on _tie_tiles: equal candidates in moved and unmoved rows,
    moved pivot rows, the diagonal exactly at tol * max; bit-equal to the
    plain version, P identical."""
    D = _tie_tiles(rng, 5, W, tol)
    lu_bit_equal(D, _eps(D), tol, f"tie tiles W={W} tol={tol}")
    log(f"[12] lu_tiles tie tiles W={W} tol={tol}: bit-equal, P identical")


def lu_pool_entry(rng, W: int, pw: int, tol: float) -> None:
    """lu_tiles_pool at a width no plan has, in pools of width pw with 4
    tiles and 3 padded slots on the pad block, against its plain version:
    both pools bit for bit."""
    L, U, dbase, D = _step_pools(rng, W, pw, 4, 3, tol)
    lu_pool_bit_equal(L, U, dbase, W, _eps(D), tol, f"W={W} pw={pw}")
    log(f"[12] lu_tiles_pool W={W} pw={pw} tol={tol}: 4 tiles and 3 padded "
        f"slots in place, both pools bit-equal to the plain version")


def lu_nan_contract(rng, W: int, nt: int, bad: int, tol: float) -> None:
    """Tile ``bad`` of ``nt`` holds a NaN: it must come out non-finite,
    every P one-hot (the identity at tol 0), and the tiles around it as
    the plain version gives them."""
    D = _lu_tiles_input(rng, nt, W, tol)
    eps = _eps(D)
    D[bad, W // 2, W // 3] = float("nan")
    F, P = lu_tiles(D, eps, tol)
    Fr, Pr = lu_tiles_ref(D, eps, tol)
    sync()
    label = f"lu_tiles W={W} tol={tol}"
    good = [t for t in range(nt) if t != bad]
    if torch.isfinite(F[bad]).all() or not torch.isfinite(F[good]).all():
        raise AssertionError(f"{label}: NaN contract broken")
    ones = torch.ones(nt, W, device=DEV)
    if not (torch.equal(P.sum(1), ones) and torch.equal(P.sum(2), ones)):
        raise AssertionError(f"{label}: P not one-hot")
    if tol == 0.0 and not torch.equal(P, torch.eye(W, device=DEV).expand_as(
            P)):
        raise AssertionError(f"{label}: P is not I")
    if not (torch.equal(P[good], Pr[good]) and torch.allclose(
            F[good], Fr[good], rtol=0,
            atol=TOL * Fr[good].abs().max().item())):
        raise AssertionError(f"{label}: good tiles next to a bad one")
    log(f"[12] lu_tiles NaN contract W={W} tol={tol}: tile {bad} of {nt} "
        f"is non-finite, every P one-hot"
        f"{' (the identity)' if tol == 0.0 else ''}, the others agree")


def lu_tiny_pivot(W: int) -> None:
    """A pivot below eps becomes +eps, or -eps where it is negative (-0.0
    counts as not negative), at tol 0 and 1, as the plain version has it;
    identity tiles otherwise."""
    D = torch.eye(W, device=DEV).repeat(4, 1, 1)
    D[:, 2, 2] = torch.tensor([1e-12, -1e-12, 0.0, -0.0], device=DEV)
    eps = 1e-6
    want = torch.tensor([1, -1, 1, 1], device=DEV) * np.float32(eps)
    for tol in (0.0, 1.0):
        F, P = lu_tiles(D, eps, tol)
        Fr, Pr = lu_tiles_ref(D, eps, tol)
        if not (torch.equal(F[:, 2, 2], want) and torch.equal(F, Fr)
                and torch.equal(P, Pr)):
            raise AssertionError(f"lu_tiles W={W} tol={tol}: tiny pivots "
                                 f"{F[:, 2, 2].tolist()}")
    log(f"[12] lu_tiles tiny-pivot contract W={W}: +-eps as the plain "
        f"version, at tol 0 and 1")


def phase_lu_kernels(plan) -> None:
    """lu_tiles at every W of ``plan`` (the g=40 LU cell's plan) at its
    largest per-step batch, the tol = 1.0 shapes (the cell's) to the
    kernels line; trsm_tiles_batched at every (H, W) of its trsm phases
    in both LU forms, off the kernels line."""
    rng = np.random.default_rng(12)
    _, trsm = _tile_shapes(plan)
    for (pw, W), (nreal, npad) in sorted(_panel_steps(plan).items()):
        for tol in (0.0, 0.001, 1.0):
            lu_shape(rng, pw, W, nreal, npad, tol, tally=tol == 1.0)
    for W in (8, 24, 32, 40, 128):      # 24 and 40: widths no plan has
        for tol in (0.001, 1.0):
            lu_ties(rng, W, tol)
    for W, pw in ((24, 32), (40, 128)):     # a warp, a block a tile
        lu_pool_entry(rng, W, pw, 1.0)
    for tol in (1.0, 0.0):
        lu_nan_contract(rng, 8, 11, 5, tol)      # four tiles share a block
        lu_nan_contract(rng, 16, 11, 5, tol)
        lu_nan_contract(rng, 128, 3, 1, tol)     # a block of its own
    lu_tiny_pivot(8)
    lu_tiny_pivot(16)
    lu_tiny_pivot(128)
    for (H, W), nt in sorted(trsm.items()):
        lu_trsm_shape(rng, nt, H, W, f"LU g=40 order 0 H={H} W={W} nt={nt}",
                      "12")


def lu_trsm_shape(rng, nt: int, H: int, W: int, label: str,
                  phase: str) -> None:
    """The two solves of an LU trsm phase by trsm_tiles_batched at one
    (nt, H, W), on operands made as SuperscanLU makes them from packed
    L\\U tiles: U_D^T (made contiguous) and the unit lower L_D.  Each is
    held against both plain versions and timed beside solve_triangular;
    neither is added to the kernels line (its B2 sums are the canonical
    plan's) nor held to the yardstick."""
    D = torch.from_numpy(_swapped_tiles(rng, nt, W).astype(np.float32))
    Dk = lu_tiles_ref(D.to(DEV), 1e-30, 1.0)[0]
    X = torch.from_numpy(rng.normal(size=(nt, H, W)).astype(
        np.float32)).to(DEV)
    eye = torch.eye(W, device=DEV)
    for form, L, unit in (("U_D^T", Dk.mT.contiguous(), False),
                          ("unit L_D", torch.tril(Dk, -1) + eye, True)):
        compare_tiles(
            "trsm_tiles_batched", (L, X),
            lambda L=L, unit=unit: torch.linalg.solve_triangular(
                L.mT, X, upper=True, left=False, unitriangular=unit),
            4 * (nt * W * (W + 1) // 2 + 2 * X.numel()), nt * H * W * W, 0.0,
            f"{label} {form}", tally=False, phase=phase)


def phase_lu_path_kernels(plan) -> None:
    """lu_tiles at tol 1 (lusol's) at every W of ``plan``, the lusol path's
    g=40 order-1 plan, at its largest per-step batch, added to the
    kernels line; trsm_tiles_batched at every (H, W) of its trsm phases in
    both LU forms, off the kernels line."""
    rng = np.random.default_rng(16)
    _, trsm = _tile_shapes(plan)
    for (pw, W), (nreal, npad) in sorted(_panel_steps(plan).items()):
        for tol in (0.0, 0.001, 1.0):
            lu_shape(rng, pw, W, nreal, npad, tol, tol == 1.0, phase="14",
                     plan="g=40 order 1")
    s = STATS["lu_tiles"]
    yardstick("lu_tiles", "sum over the kernels line's shapes", s["ms"],
              s["library_ms"])
    for (H, W), nt in sorted(trsm.items()):
        lu_trsm_shape(rng, nt, H, W, f"LU g=40 order 1 H={H} W={W} nt={nt}",
                      "14")


def _segment_steps(seg) -> dict:
    """{phase kind: the segment's non-empty steps}, as the factor's step
    loop walks them: one launch of the phase's kernel each (two for trsm
    in the LU)."""
    out = {}
    for key, arrs in seg.xs.items():
        lad = seg.ladders.get(key)
        for step in range(seg.hi - seg.lo):
            bs = (next(iter(arrs.values())).shape[1] if lad is None
                  else lad[int(seg.lvls[key][step])])
            if bs:
                out[key[0]] = out.get(key[0], 0) + 1
    return out


def _phase_steps(plan) -> dict:
    """_segment_steps summed over the plan's segments."""
    out = {}
    for seg in plan.segments:
        for kind, n in _segment_steps(seg).items():
            out[kind] = out.get(kind, 0) + n
    return out


def profile_factor_tail(F: SuperscanLU, share: float) -> str:
    """A warm F.factor() with torch.profiler on only over its last
    segments that hold ``share`` of the plan's non-empty steps (the
    largest panels), summed by _profile_summary with H1's and B2's
    kernels named.  A whole g=40 factor is some 157,000 device ops, which
    the profiler takes minutes to sort."""
    segs = [seg for seg in F.plan.segments if seg.xs]   # as _factor walks
    steps = [sum(_segment_steps(seg).values()) for seg in segs]
    first = len(segs)
    while first and sum(steps[first:]) < share * sum(steps):
        first -= 1
    inner, prof, seen, t = superscan._segment_factor, _profiler(), [0], {}

    def segment_factor(*args):
        if seen[0] == first:
            sync()
            prof.start()
            t["start"] = time.perf_counter()
        inner(*args)
        seen[0] += 1
        if seen[0] == len(segs):
            sync()
            t["wall"] = time.perf_counter() - t["start"]
            prof.stop()

    superscan._segment_factor = segment_factor
    try:
        if not F.factor():
            raise AssertionError("LU g=40 profiled factor failed")
    finally:
        superscan._segment_factor = inner
    return (f"segments {first}-{len(segs) - 1} of {len(segs)} "
            f"({sum(steps[first:])} of {sum(steps)} non-empty steps): "
            + _profile_summary(prof, t["wall"], {
                "H1": "lu_tile_kernel", "B2": "trsm_tile_kernel"}))


def phase_lu_cell(F: SuperscanLU, A: CSCMatrix, t_plan: float,
                  compare: bool) -> dict:
    """Returns the launches of the first factor (a main path).  With
    ``compare``, two more factors hold the panel entries' pools against
    each other (compare_panel_entries)."""
    plan = F.plan
    check_plan(plan, A, LU_CELL, segments=len(plan.segments))
    steps = _phase_steps(plan)
    if {k: steps.get(k, 0) for k in LU_PHASES} != LU_PHASES:
        raise AssertionError(f"LU plan phases {steps}")
    base = fresh_memory()
    reset_launches()
    t0 = time.perf_counter()
    ok = F.factor()
    t_first = time.perf_counter() - t0
    counts = launches()
    if not ok:
        raise AssertionError(f"LU g=40 factor failed (growth {F.growth})")
    expect = {name: 0 for name in KERNELS}
    expect.update(lu_tiles=steps["chol"],
                  trsm_tiles_batched=2 * steps["trsm"])
    if counts != expect:
        raise AssertionError(f"LU g=40 launches {counts}, want {expect}")
    t0 = time.perf_counter()
    if not F.factor():
        raise AssertionError("LU g=40 warm factor failed")
    t_warm = time.perf_counter() - t0
    b = 1.0 + np.arange(A.n) / A.n                  # bench.py's b
    F._solve_f32(b)                                  # uploads the schedule
    t0 = time.perf_counter()
    F._solve_f32(b)
    t_solve32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = F.solve(b)
    t_solve = time.perf_counter() - t0
    r = check_solution("LU g=40", A, x, b, RESID)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[13] LU cell g=40 n={A.n} order 0: plan {t_plan:.2f} s, "
        f"{len(plan.segments)} segments, {len(plan.panels)} panels, lnz "
        f"{plan.lnz}, flops_true {plan.flops_true}, flops_padded "
        f"{plan.flops_padded}, waste {plan.waste_ratio:.4f}, phases {steps}")
    log(f"[13] LU cell: factor first {t_first:.3f} s, warm "
        f"{t_warm:.3f} s ({2 * plan.flops_true / t_warm / 1e9:.2f} "
        f"GFLOP/s on the LU's 2 x flops_true), growth {F.growth:.4f}, f32 "
        f"solve {t_solve32:.3f} s, refined solve {t_solve:.3f} s, residual "
        f"{r:.3e}, peak device memory {peak:.2f} GiB (of it "
        f"{base / 1024:.2f} GiB held before the phase), launches in the "
        f"first factor {counts}")
    log(f"[13] warm factor profiled, {profile_factor_tail(F, 0.1)}")
    if compare:
        compare_panel_entries(F)
    return counts


def _gather_panel(pools, key, a, c, eps, tol):
    """The panel phase as a gather, lu_tiles and a padded index_copy_ of
    whole pool rows: SuperscanLU's path before lu_tiles_pool."""
    _, pw, W = key
    lu_tiles_pool_ref(pools[("L", pw)], pools[("U", pw)], a["dbase"], W,
                      eps, tol, lu=lu_tiles)


def compare_panel_entries(F: SuperscanLU) -> None:
    """Two factors of the LU cell with deterministic index_add_ and
    index_copy_, one through lu_tiles_pool (in place) and one through
    the gather path: every pool bit for bit, pad block and padded slots
    included."""
    pools = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for panel in (superscan_lu._panel, _gather_panel):
            inner, superscan_lu._panel = superscan_lu._panel, panel
            try:
                if not F.factor():
                    raise AssertionError("LU g=40 factor failed")
            finally:
                superscan_lu._panel = inner
            pools.append({k: v.clone() for k, v in F.pools.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    for k, v in pools[0].items():
        if not torch.equal(v, pools[1][k]):
            raise AssertionError(
                f"LU g=40 pool {k}: in place and gathered differ by "
                f"{(v - pools[1][k]).abs().max().item():.3e}")
    log(f"[13] LU cell pools through lu_tiles_pool and through the gather "
        f"path (deterministic index_add_): all {len(pools[0])} bit-equal")


def timed_lusol(A: CSCMatrix, b: np.ndarray, **kw) -> tuple:
    """tpusparse_torch.lusol(1, A, b, device=DEV, **kw) with the launch
    counters reset just before it and its TpuLU timed: returns (the TpuLU
    it made, ok, x, launches, wall s)."""
    solvers.TpuLU = timed = _timed(TpuLU)
    try:
        reset_launches()
        t0 = time.perf_counter()
        ok, x = tpusparse_torch.lusol(1, A, b, device=DEV, **kw)
        sync()
        t_all = time.perf_counter() - t0
        counts = launches()
    finally:
        solvers.TpuLU = TpuLU
    if len(timed.made) != 1:
        raise AssertionError(f"lusol made {len(timed.made)} TpuLU objects")
    return timed.made[0], ok, x, counts, t_all


def mixed_btf(seed: int = 0) -> CSCMatrix:
    """Block upper triangular: two random unsymmetric blocks (40 and 300
    rows, dense LU on the card) and conv_diff_3d(16) (4,096 rows, the
    superscan LU), coupled above the diagonal blocks only."""
    rng = np.random.default_rng(seed)
    blocks = []
    for n, dens in ((40, 0.3), (300, 0.05)):
        d = rng.normal(size=(n, n)) * (rng.random((n, n)) < dens)
        blocks.append(sp.csc_matrix(d + np.diag(np.abs(d).sum(1) + 1.0)))
    blocks.append(conv_diff_3d(16).toscipy())
    M = sp.block_diag(blocks, format="csc")
    N = M.shape[0]
    owner = np.repeat(np.arange(3), [b.shape[0] for b in blocks])
    C = sp.random(N, N, density=2e-4, random_state=seed, format="coo")
    up = owner[C.row] < owner[C.col]
    C = sp.coo_matrix((0.1 * C.data[up], (C.row[up], C.col[up])),
                      shape=(N, N))
    return _csc(M + C)


def phase_lusol() -> dict:
    """Returns the launches of lusol on the g=40 matrix (the main path)."""
    A = conv_diff_3d(LU_CELL["g"])
    b = np.random.default_rng(14).normal(size=A.n)
    base = fresh_memory()
    T, ok, x, counts, t_all = timed_lusol(A, b)
    if not ok:
        raise AssertionError("lusol g=40 returned ok=False")
    if not (counts["lu_tiles"] > 0 and counts["trsm_tiles_batched"] > 0):
        raise AssertionError(f"lusol skipped an LU kernel: {counts}")
    r = check_solution("lusol g=40", A, x, b, RESID)
    sparse = [blk.sparse for blk in T.blocks if blk.sparse is not None]
    if len(sparse) != 1:
        raise AssertionError(f"lusol g=40: {len(sparse)} sparse blocks")
    p = sparse[0].plan
    log(f"[14] lusol g=40 n={A.n}: {T.nb} BTF block(s), SuperscanLU order 1: "
        f"{len(p.segments)} segments, {len(p.panels)} panels, lnz {p.lnz}, "
        f"flops_true {p.flops_true}, flops_padded {p.flops_padded}, waste "
        f"{p.waste_ratio:.4f}, phases {_phase_steps(p)}, growth "
        f"{sparse[0].growth:.4f}; lusol total {t_all:.2f} s (BTF "
        f"{T.t['plan']:.2f} s, factor with the block's plan "
        f"{T.t['factor'][0]:.2f} s, refined solve {T.t['solve']:.2f} s), "
        f"residual "
        f"{r:.3e}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (of it "
        f"{base / 1024:.2f} GiB held before), launches {counts}")
    phase_lu_path_kernels(p)
    del T, sparse

    A = mixed_btf()
    b = np.random.default_rng(15).normal(size=A.n)
    T, ok, x, _, t_all = timed_lusol(A, b)
    if not ok:
        raise AssertionError("lusol mixed BTF returned ok=False")
    r = check_solution("lusol mixed BTF", A, x, b, RESID)
    dense = [blk for blk in T.blocks if blk.size > 1 and blk.sparse is None]
    nsparse = sum(blk.sparse is not None for blk in T.blocks)
    if not (dense and nsparse and all(blk.LU.is_cuda for blk in dense)):
        raise AssertionError(f"lusol mixed BTF: {len(dense)} dense blocks "
                             f"on the card, {nsparse} sparse")
    log(f"[14] lusol mixed BTF n={A.n}: {T.nb} blocks, dense on the card "
        f"(size/pad) {[(blk.size, blk.pad) for blk in dense]}, {nsparse} "
        f"sparse; total {t_all:.2f} s, residual {r:.3e}")

    A = conv_diff_2d(48, (50, 200, 350))
    b = 1.0 + np.arange(A.n) / A.n
    for tol in (1.0, 0.0):
        T, ok, x, _, _ = timed_lusol(A, b, tol=tol)
        if not ok:
            raise AssertionError(f"lusol weak diagonal tol={tol}: ok=False")
        r = check_solution(f"lusol weak diagonal tol={tol}", A, x, b, RESID)
        m = [blk.sparse.match_alpha for blk in T.blocks if blk.sparse]
        log(f"[14] lusol weak diagonal n={A.n} tol={tol}: residual {r:.3e} "
            f"(bottleneck matching on: alpha {m})")
    for tol in (1.0, 0.0):
        F = SuperscanLU(A, order=1, tol=tol, match=False, device=DEV)
        ok = F.factor()
        try:
            r = check_solution("", A, F.solve(b), b, RESID) if ok else None
        except (ValueError, AssertionError):
            r = None
        if (r is not None) != (tol == 1.0):
            raise AssertionError(f"SuperscanLU weak diagonal, no matching, "
                                 f"tol={tol}: factor {ok}, residual {r}")
        log(f"[14] SuperscanLU weak diagonal, no matching, tol={tol}: "
            f"factor {ok}, growth {F.growth:.3e}, "
            + (f"residual {r:.3e}" if r is not None else "flagged"))

    for label, d in (("rank 1", np.outer(np.arange(1.0, 7.0), np.ones(6))),
                     ("zero column", np.where(np.arange(8) == 3, 0.0,
                                              np.eye(8) + 0.5))):
        out = tpusparse_torch.lusol(1, _csc(sp.csc_matrix(d)),
                                    np.ones(d.shape[0]), device=DEV)
        if out != (False, None):
            raise AssertionError(f"lusol singular ({label}): {out}")
    log("[14] singular (rank 1; a zero column): lusol -> (False, None)")
    return counts


# ----------------------------------------------------------- SpMV
def _library(A: CSCMatrix):
    """cuSPARSE CSR matvec of A (float32) as one PyTorch call: the
    yardstick, used nowhere in the port."""
    S = A.toscipy().tocsr().astype(np.float32)
    T = torch.sparse_csr_tensor(
        torch.from_numpy(S.indptr.astype(np.int32)),
        torch.from_numpy(S.indices.astype(np.int32)),
        torch.from_numpy(S.data), size=S.shape).to(DEV)
    return lambda x: T @ x


def _x(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=n).astype(np.float32)).to(DEV)


def _nonzero(t: torch.Tensor) -> int:
    return int(torch.count_nonzero(t).item())


def kernels_dia(plan, label: str, A: CSCMatrix) -> tuple:
    """Phase 7 for the DIA plan of A; returns (kernel ms, its bytes).
    The bytes are those the product needs: the nonzero band entries,
    the offsets, x and y, each once (band padding is left out)."""
    (bands,) = plan._bufs
    offs = torch.tensor(plan.offsets.astype(np.int32), device=DEV)
    x = _x(plan.n, 7)
    lib = _library(A)
    err, rel = rel_err(dia_spmv(bands, offs, x),
                       dia_spmv_ref(bands, offs, x), f"dia_spmv {label}")
    ms = cuda_ms(lambda: dia_spmv(bands, offs, x))
    pms = cuda_ms(lambda: dia_spmv_ref(bands, offs, x))
    lms = cuda_ms(lambda: lib(x))
    hus = host_s(lambda: dia_spmv(bands, offs, x)) * 1e6
    nz = _nonzero(bands)
    nbytes = (nz + offs.numel() + plan.n + plan.m) * 4
    b = record("dia_spmv", err, ms, pms, lms, nbytes, 2 * nz)
    log(f"[7] dia_spmv {label} ndiag={bands.shape[0]} m={plan.m}: "
        f"max_abs_err {err:.3e} (rel {rel:.1e}), kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, cuSPARSE {lms:.4f} ms, bound {b:.4f} ms "
        f"({nbytes / 1e6:.1f} MB), {nbytes / ms / 1e6:.0f} GB/s, wrapper "
        f"host {hus:.1f} us/call")
    return ms, nbytes


def sell_bytes(pack: tuple, n: int) -> tuple:
    """(bytes needed, bytes read, padded slab bytes, entries) of the
    product over one S class, from its compact pack.  Needed: vals (4
    bytes) and window-relative pos (2) of its real (nonzero) entries,
    bids and win, each x entry those entries read and each y row of its
    blocks, once.  Read by the kernel: those and the pack's off, start
    and rows.  The planner's slabs held 8 S * 128 slots of 8 bytes a
    block."""
    bids, win, off, start, rows, cpos, _ = pack
    NB, D = bids.shape[0], start.shape[1] - 1
    st = start.long()
    blk = torch.repeat_interleave(torch.arange(NB, device=DEV), st[:, -1])
    p = cpos.long()
    j = win.long()[blk, p >> 10] * 1024 + (p & 1023)
    nx = torch.unique(j).numel()
    ny = int((bids.long()[:, None] * 128 + rows.long() < n).sum().item())
    nz = cpos.numel()
    need = nz * 6 + (bids.numel() + win.numel() + nx + ny) * 4
    read = need + off.numel() * 4 + start.numel() * 2 + rows.numel()
    return need, read, NB * D * 128 * 8, nz


def kernels_sell(plan, label: str, A_perm: CSCMatrix,
                 tally: bool = True) -> tuple:
    """Phase 7 for a SELL plan, class by class; returns (kernel ms of
    one pass over all classes, its bytes).  ``A_perm`` is the matrix in
    the plan's ordering, for the cuSPARSE yardstick.  With ``tally``
    false (a plan off the main path) the checks run and the times are
    printed, but nothing is added to the kernels line."""
    _sr, _sc, _sv, _p, _pi, *flat = plan._bufs
    n = plan.n
    x = _x(n, 8)
    tot_ms = tot_pms = tot_bytes = tot_b = tot_read = slab_bytes = 0.0
    tot_nz = 0
    for ci in range(len(flat) // PACK):
        pack = flat[PACK * ci:PACK * (ci + 1)]
        bids, win, start = pack[0], pack[1], pack[3]
        NB, S = bids.shape[0], (start.shape[1] - 1) // 8
        y, r = torch.zeros(n, device=DEV), torch.zeros(n, device=DEV)
        err, rel = rel_err(sell_spmv(*pack, x, y), sell_spmv_ref(*pack, x, r),
                           f"sell_spmv {label} S={S}")
        ms = cuda_ms(lambda: sell_spmv(*pack, x, y))
        pms = cuda_ms(lambda: sell_spmv_ref(*pack, x, r))
        hus = host_s(lambda: sell_spmv(*pack, x, y)) * 1e6
        nbytes, nread, slabs, nz = sell_bytes(pack, n)
        if tally:
            b = record("sell_spmv", err, ms, pms, 0.0, nbytes, 2 * nz)
        else:
            b, _ = bound_ms(nbytes, 2 * nz)
        tot_ms, tot_pms, tot_bytes, tot_b = (tot_ms + ms, tot_pms + pms,
                                             tot_bytes + nbytes, tot_b + b)
        tot_read += nread
        tot_nz += nz
        slab_bytes += slabs
        log(f"[7] sell_spmv {label} S={S} NB={NB} TW={win.shape[1]}: "
            f"max_abs_err {err:.3e} (rel {rel:.1e}), kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, bound {b:.4f} ms ({nbytes / 1e6:.1f} MB "
            f"needed; the kernel reads {nread / 1e6:.1f} MB; slabs with "
            f"padding {slabs / 1e6:.1f} MB), wrapper host {hus:.1f} us/call")
    if not tot_read <= SELL_READ_MAX * tot_bytes:
        raise AssertionError(
            f"sell_spmv {label}: the kernel reads {tot_read / 1e6:.1f} MB, "
            f"over {SELL_READ_MAX} x the {tot_bytes / 1e6:.1f} MB needed")
    lib = _library(A_perm)
    lms = cuda_ms(lambda: lib(x))
    if tally:
        STATS["sell_spmv"]["library_ms"] += lms
    note = "" if tally else " (off the main path: not in the kernels line)"
    log(f"[7] sell_spmv {label} all classes{note}: "
        f"kernel {tot_ms:.4f} ms, plain {tot_pms:.4f} ms, cuSPARSE "
        f"{lms:.4f} ms (the whole product), bound {tot_b:.4f} ms "
        f"({tot_bytes / 1e6:.1f} MB needed), {tot_bytes / tot_ms / 1e6:.0f} "
        f"GB/s on them; the kernel reads {tot_read / 1e6:.1f} MB = "
        f"{tot_read / tot_bytes:.3f} x needed, {tot_read / tot_ms / 1e6:.0f} "
        f"GB/s; slabs with padding {slab_bytes / 1e6:.1f} MB; with 4-byte "
        f"positions, as the slabs and CSR hold them, the product would "
        f"need {(tot_bytes + 2 * tot_nz) / 1e6:.1f} MB")
    return tot_ms, tot_bytes


def kernels_bell(plan, label: str, A: CSCMatrix) -> tuple:
    """Phase 7 for the BELL plan of A; returns (kernel ms, its bytes).
    The bytes are those the product needs: the nonzero tile entries,
    the column of each tile that has one, x and y, each once (padding
    tiles are left out)."""
    vals, tile_cols = plan._bufs
    x = _x(plan.n, 9)
    lib = _library(A)
    err, rel = rel_err(bell_spmv(vals, tile_cols, x, plan.m),
                       bell_spmv_ref(vals, tile_cols, x, plan.m),
                       f"bell_spmv {label}")
    ms = cuda_ms(lambda: bell_spmv(vals, tile_cols, x, plan.m))
    pms = cuda_ms(lambda: bell_spmv_ref(vals, tile_cols, x, plan.m))
    lms = cuda_ms(lambda: lib(x))
    hus = host_s(lambda: bell_spmv(vals, tile_cols, x, plan.m)) * 1e6
    nz = _nonzero(vals)
    ntiles = _nonzero(vals.abs().amax((2, 3)))
    nbytes = (nz + ntiles + plan.n + plan.m) * 4
    b = record("bell_spmv", err, ms, pms, lms, nbytes, 2 * nz)
    log(f"[7] bell_spmv {label} K={vals.shape[1]} nbr={vals.shape[0]}: "
        f"max_abs_err {err:.3e} (rel {rel:.1e}), kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, cuSPARSE {lms:.4f} ms, bound {b:.4f} ms "
        f"({nbytes / 1e6:.1f} MB), {nbytes / ms / 1e6:.0f} GB/s, wrapper "
        f"host {hus:.1f} us/call")
    return ms, nbytes


# name, matrix maker, auto mode, kernel of that mode
SPMV_CASES = [
    ("continuity", lambda: grid_spd(512), "dia", "dia_spmv"),
    ("banded", lambda: grid_spd_3d(128), "dia", "dia_spmv"),
    ("irregular", lambda: irregular_graph(1 << 20), "sell", "sell_spmv"),
    ("irregular_rcm_order", None, "sell", "sell_spmv"),
    ("block", block_matrix, "bell", "bell_spmv"),
    ("power_law", lambda: ba_graph(1 << 17), "seg", None),
]


def spmv_case(name: str, A: CSCMatrix, mode: str, kname) -> tuple:
    """Phase 8 for one matrix (the counted path), then phase 7 on its
    plan.  Returns (plan, launches)."""
    base = fresh_memory()
    x_np = np.random.default_rng(3).normal(size=A.n)
    yref = A.toscipy() @ x_np                        # float64
    reset_launches()
    t0 = time.perf_counter()
    plan = tpusparse_torch.spmv_plan(A, "auto", device=DEV)
    t_plan = time.perf_counter() - t0
    y = plan.apply(x_np)
    sync()
    counts = launches()
    if plan.mode != mode:
        raise AssertionError(f"{name}: auto chose {plan.mode}, not {mode}")
    if kname and counts[kname] == 0:
        raise AssertionError(f"{name}: {kname} never launched: {counts}")
    if sum(counts.values()) != (counts[kname] if kname else 0):
        raise AssertionError(f"{name}: another kernel launched: {counts}")
    scale = np.abs(yref).max()
    err = np.abs(y.cpu().numpy() - yref).max()
    if not (y.shape == (A.m,) and err <= TOL * scale):
        raise AssertionError(f"{name}: y rel err {err / scale:.3e}")
    identity = plan.perm is not None and np.array_equal(plan.perm,
                                                        np.arange(A.n))
    if name == "irregular":          # the large SELL case
        y0 = np.random.default_rng(4).normal(size=A.m)
        g = plan.gaxpy(x_np, y0).cpu().numpy()
        if not np.abs(g - (yref + y0)).max() <= TOL * scale:
            raise AssertionError("irregular: gaxpy")
        p = plan.perm
        yp = plan.apply_permuted(x_np[p]).cpu().numpy()
        if not np.abs(yp - yref[p]).max() <= TOL * scale:
            raise AssertionError("irregular: apply_permuted")
    peak = torch.cuda.max_memory_allocated()

    x0 = torch.as_tensor(x_np, dtype=torch.float32, device=DEV)

    def loop(matvec) -> tuple:
        """Seconds per apply of 50 applies, each on 0.125 times the last
        result: (what an iterative solver's host loop pays, launch time
        included; the device time alone, the queue filled first)."""
        def run():
            x = x0
            for _ in range(50):
                x = 0.125 * matvec(x)
            return x
        return (cuda_ms(run, reps=1, runs=5, queued=False) / 50e3,
                cuda_ms(run, reps=1, runs=5) / 50e3)

    t_apply, t_dev = loop(plan.apply)
    t_host = host_s(lambda: 0.125 * plan.apply(x0), reps=50)
    lib = _library(A)
    t_lib, _ = loop(lib)
    kern = ""
    if mode == "dia":
        kms, kbytes = kernels_dia(plan, name, A)
    elif mode == "bell":
        kms, kbytes = kernels_bell(plan, name, A)
    elif mode == "sell":
        Ap = A if identity else _csc(A.toscipy()[plan.perm][:, plan.perm])
        kms, kbytes = kernels_sell(plan, f"{name} v1", Ap)
    if kname:
        kern = (f", kernel {kms * 1e3:.1f} us on {kbytes / 1e6:.1f} MB "
                f"= {kbytes / kms / 1e6:.0f} GB/s")
    log(f"[8] {name} n={A.n} nnz={A.nnz}: mode {plan.mode}"
        f"{' identity' if identity else (' rcm' if mode == 'sell' else '')}"
        f", plan {t_plan:.2f} s, y rel err {err / scale:.2e}, apply "
        f"{t_apply * 1e6:.1f} us (50-apply y-carry, median of 5) = "
        f"{plan.bytes_min / t_apply / 1e9:.0f} GB/s on bytes_min "
        f"({plan.bytes_min / 1e6:.1f} MB), of it device {t_dev * 1e6:.1f} "
        f"us (idle {1 - t_dev / t_apply:.2f}) and the host takes "
        f"{t_host * 1e6:.1f} us to queue one{kern}, cuSPARSE "
        f"{t_lib * 1e6:.1f} us (same loop), spill "
        f"{plan.spill / A.nnz:.2e}, waste "
        f"{plan.waste_ratio:.3f}, peak device memory {peak / 2**20:.0f} "
        f"MiB (of it {base:.0f} MiB held before the case), launches "
        f"{counts}")
    return plan, counts


def phase_spmv() -> dict:
    totals = {name: 0 for name in KERNELS}
    prev = prev_A = None
    for name, make, mode, kname in SPMV_CASES:
        t0 = time.perf_counter()
        if make is None:               # the previous matrix, in its plan's
            p = prev.perm              # own ordering (no second RCM)
            A = _csc(prev_A.toscipy()[p][:, p])
        else:
            A = make()
        t_make = time.perf_counter() - t0
        plan, counts = spmv_case(name, A, mode, kname)
        for k, v in counts.items():
            totals[k] += v
        if name == "irregular_rcm_order":
            # the v2 slab layout of the same matrix, every S class
            old = os.environ.get("TPUSPARSE_SELL_KERNEL")
            os.environ["TPUSPARSE_SELL_KERNEL"] = "2"
            try:
                p2 = tpusparse_torch.spmv_plan(A, "sell", device=DEV)
            finally:
                if old is None:
                    del os.environ["TPUSPARSE_SELL_KERNEL"]
                else:
                    os.environ["TPUSPARSE_SELL_KERNEL"] = old
            kernels_sell(p2, f"{name} v2", A, tally=False)
        log(f"[8] {name}: matrix made in {t_make:.2f} s")
        prev, prev_A = plan, A
    s = STATS["sell_spmv"]
    yardstick("sell_spmv", "both kNN cases against cuSPARSE CSR", s["ms"],
              s["library_ms"])
    return totals


def timed(label: str, fn, *args):
    """fn(*args), then a line with its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{label}] phase wall time {time.perf_counter() - t0:.1f} s")
    return out


PHASES = ("3", "4", "5", "6", "8", "9", "10", "11", "12", "13", "14")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + " ".join(PHASES)
                    + " (phase 7 runs inside 8); a subset prints no result "
                    "lines")
    want = set(ap.parse_args().phases.split(","))
    if not want <= set(PHASES):
        ap.error(f"unknown phases {sorted(want - set(PHASES))}")
    t_start = time.perf_counter()
    timed("1", phase_device)
    timed("2", phase_build)
    counts = {name: 0 for name in KERNELS}
    steps = None
    if want & {"3", "4"}:
        A = grid_spd_3d(24)
        t0 = time.perf_counter()
        F = SuperscanCholesky(A, order=1, device=DEV)
        t_plan = time.perf_counter() - t0
        if "3" in want:
            steps = timed("3", phase_kernels, F.plan)
        if "4" in want:
            timed("4", phase_canonical, F, A, t_plan)
        del F
        torch.cuda.empty_cache()
    if "5" in want:
        counts, plan48 = timed("5", phase_large)
        if steps is not None:
            timed("3, g=48 batches", phase_kernels_large, plan48, *steps)
        del plan48
    if "6" in want:
        timed("6", phase_failure)
    if "8" in want:
        spmv_counts = timed("7+8", phase_spmv)
        for name in ("dia_spmv", "sell_spmv", "bell_spmv"):
            counts[name] = spmv_counts[name]
    if "9" in want:
        timed("9", phase_supernodal)
    if "10" in want:
        tiled_counts = timed("10", phase_tiled)
        counts["chol_tiles"] += tiled_counts["chol_tiles"]
        counts["trsm_tiles"] = tiled_counts["trsm_tiles"]
    if "11" in want:
        timed("11", phase_updown)
    if want & {"12", "13"}:
        A = conv_diff_3d(LU_CELL["g"])
        t0 = time.perf_counter()
        F = SuperscanLU(A, order=0, max_segments=12, device=DEV)
        t_plan = time.perf_counter() - t0
        if "12" in want:
            timed("12", phase_lu_kernels, F.plan)
        if "13" in want:
            lu_counts = timed("13", phase_lu_cell, F, A, t_plan,
                              want != set(PHASES))
            for name in ("lu_tiles", "trsm_tiles_batched"):
                counts[name] += lu_counts[name]
        del F
        fresh_memory()
    if "14" in want:
        lu_counts = timed("14", phase_lusol)
        for name in ("lu_tiles", "trsm_tiles_batched"):
            counts[name] += lu_counts[name]
    log(f"[end] wall time {time.perf_counter() - t_start:.1f} s")
    if want != set(PHASES):
        log(f"partial run (phases {sorted(want, key=PHASES.index)}): no "
            f"result lines")
        return
    idle = [name for name, c in counts.items() if c == 0]
    if idle:
        raise AssertionError(f"never launched on a main path: {idle}")
    kernels = []
    for name, k in KERNELS.items():
        s = STATS[name]
        kernels.append(dict(
            name=name, route="cuda", source=k["source"],
            replaces=k["replaces"], launches=counts[name],
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=("bytes" if s["bytes_ms"] >= s["ops_ms"]
                      else "operations"),
            library_ms=s["library_ms"], chain_ms=s["chain_ms"] or None))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
