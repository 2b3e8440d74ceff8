"""The harness on the CPU: result lines, seeds, the frozen counts, the
runner's refusal without a card, BENCHMARK.json against the contract,
and a cell, configuration and metric added by new files only."""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, copy_root

from benchmark import harness
from benchmark.metrics import _roofline
from benchmark.reference import spmv as ref_spmv

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HOST_READ = {"plan_s", "refine_share", "spmv_issue_us"}


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny_root, cell, trace):
    r = harness.run_cell(tiny_root, cell, 2 ** 33 + 5, 0.3, bool(trace),
                         device="cpu")
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    json.dumps(r)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind] if _reports(m, cell)}
    got = set(r["metrics"])
    if trace:
        # without a card only the host-clock readers find something
        assert got == want & HOST_READ
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert got == want
    for name, m in r["metrics"].items():
        unit = {x["name"]: x["unit"] for x in BENCH[kind]}[name]
        assert m["unit"] == unit and np.isfinite(m["value"])
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("config", ["poisson3d_g48", "poisson3d_g200"])
def test_seeds_fix_the_requests_not_the_matrix(tiny_root, config):
    """The matrix is the configuration's own, the same for every seed;
    the seed draws the requests and the check's probes."""
    cell = [w["name"] for w in BENCH["workloads"] if w["config"] == config][0]
    spec = harness.Spec(tiny_root, cell)
    ctx = [harness.Context(spec, s, torch.device("cpu"), False, False)
           for s in (11, 2 ** 32 + 11)]
    for u, v in zip(ctx[0].A, ctx[1].A):
        assert np.array_equal(u, v)
    for stream in (1, 2, 3):
        assert not np.array_equal(ctx[0].rng(stream).uniform(size=4),
                                  ctx[1].rng(stream).uniform(size=4))


def test_the_matrices_are_the_sources_own():
    """ex2's 5-point and HYPRE's 7-point Laplacians with unit
    coefficients and no shift: 4 and 6 on the diagonal, -1 off it, and
    every row sum 0 away from the boundary."""
    from benchmark.matrices import poisson2d, poisson3d
    import scipy.sparse as sp
    for build, coef, diag in ((poisson2d.build, [1.0, 1.0], 4.0),
                              (poisson3d.build, [1.0, 1.0, 1.0], 6.0)):
        m, n, indptr, indices, data = build({"grid": 5, "coef": coef}, None)
        A = sp.csc_matrix((data, indices, indptr), shape=(m, n))
        assert (A - A.T).nnz == 0 and set(A.diagonal()) == {diag}
        assert set(A.data) == {diag, -1.0}
        assert (abs(A).sum(axis=1) <= 2 * diag).all()
        assert (np.asarray(A.sum(axis=1)).ravel() == 0).any()


def test_the_time_metric_comes_from_benchmark_json(tiny_root):
    want = {"poisson3d_g48.factor": ("factor_ms", "ms"),
            "poisson3d_g48.solve": ("solve_ms", "ms"),
            "poisson3d_g200.spmv": ("spmv_us", "us")}
    for cell in CELLS:
        tm = harness.Spec(tiny_root, cell).time_metric
        assert (tm["name"], tm["unit"]) == want[cell]
        assert tm["unit"] in harness.TIME_UNITS


def test_request_streams_are_seeded(tiny_root):
    spec = harness.Spec(tiny_root, "poisson3d_g200.spmv")
    ctx = [harness.Context(spec, 77, torch.device("cpu"), False, False)
           for _ in range(2)]
    assert np.array_equal(ctx[0].rng(1).uniform(size=5),
                          ctx[1].rng(1).uniform(size=5))
    x = [torch.rand(5, generator=c.torch_generator()) for c in ctx]
    assert torch.equal(x[0], x[1])


def test_spmv_sample_is_seeded():
    from benchmark.ops.spmv import _Reservoir
    picks = []
    for _ in range(2):
        r = _Reservoir(8, np.random.default_rng([5, 3]))
        slots = [None] * 8
        for i in range(10_000):
            k = r.offer()
            if k is not None:
                slots[k] = i
        picks.append(sorted(slots))
    assert picks[0] == picks[1] and len(set(picks[0])) == 8
    assert max(picks[0]) > 1_000       # the sample reaches past the start


def test_frozen_counts_reproduce_the_kernel_table():
    """B1 0.0001 ms and B2 0.0010 ms (0.0009977) summed over the canonical
    g=24 plan's chol and trsm shapes at their largest batches."""
    from benchmark.matrices import poisson3d
    from tpusparse_torch.core.matrix import CSCMatrix
    from tpusparse_torch.device.superscan import SuperscanCholesky
    A = poisson3d.build({"grid": 24, "coef": [1.0, 1.0, 1.0]}, None)
    plan = SuperscanCholesky(CSCMatrix(*A), order=1, device="cpu").plan
    chol, trsm = {}, {}
    for seg in plan.segments:
        for key, arrs in seg.xs.items():
            bs = next(iter(arrs.values())).shape[1]
            if key[0] == "chol":
                chol[key[2]] = max(chol.get(key[2], 0), bs)
            elif key[0] == "trsm":
                trsm[key[2:4]] = max(trsm.get(key[2:4], 0), bs)
    b1 = sum(_roofline.bound_s(*_roofline.chol_tiles_counts((nt, W, W)))
             for W, nt in chol.items()) * 1e3
    b2 = sum(_roofline.bound_s(*_roofline.trsm_tiles_batched_counts(
        (nt, R, W))) for (R, W), nt in trsm.items()) * 1e3
    assert (len(chol), len(trsm)) == (5, 22)
    assert round(b1, 4) == 0.0001
    assert round(b2, 4) == 0.0010 and abs(b2 - 0.0009977) < 5e-8


def test_round_tf32():
    v = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -12,
                      1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11 + 2.0 ** -12)])
    want = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]
    assert ref_spmv.round_tf32(v).tolist() == want


def test_runner_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "not run" in p.stderr


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs
        assert len(w["why"]) <= 200
        for part in ("traffic", w["traffic"] + ".json"), (
                "limits", w["name"] + ".json"):
            assert os.path.isfile(os.path.join(ROOT, "benchmark", *part))
        reported = {m["name"] for m in BENCH["end_to_end"]
                    if _reports(m, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in BENCH["per_layer"] if _reports(m, w["name"])]
        assert layer
        for m in layer:
            assert m["moves"] in reported
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    for m in BENCH["per_layer"]:
        assert {"workloads", "layer", "moves"} <= set(m)
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _digest(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" not in d:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = \
                        hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_config_and_metric_need_new_files_only(tmp_path):
    """A throwaway configuration, cell and per-layer metric, added as new
    files and new BENCHMARK.json entries, run with no file of the
    benchmark changed."""
    root = copy_root(str(tmp_path / "root"))
    before = _digest(root)
    b = os.path.join(root, "benchmark")
    cfg = {"name": "tiny2d", "matrix": {"builder": "poisson2d", "grid": 12,
                                        "coef": [1.0, 2.0]},
           "solver": {"order": 1}, "guarantees": {"grade": 1e-14}}
    with open(os.path.join(b, "configs", "tiny2d.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "limits", "tiny2d.factor.json"), "w") as f:
        json.dump({"backward_error": 1e-5, "launch_gap": 0}, f)
    with open(os.path.join(b, "metrics", "traced_requests.py"), "w") as f:
        f.write("def read(tr):\n    return float(tr.requests)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny2d", "source": "a test",
                             "file": "benchmark/configs/tiny2d.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny2d.factor", "config": "tiny2d",
                               "traffic": "factor", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "traced_requests", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "factor_ms",
                               "workloads": ["tiny2d.factor"]})
    for m in bench["end_to_end"]:
        if m["name"] == "factor_ms":
            m["workloads"].append("tiny2d.factor")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = harness.run_cell(root, "tiny2d.factor", 3, 2.0, True, device="cpu")
    assert r["correct"] and r["metrics"]["traced_requests"]["value"] == 1.0
    r = harness.run_cell(root, "tiny2d.factor", 3, 0.2, False, device="cpu")
    assert set(r["metrics"]) == {"setup_s", "factor_ms", "peak_mib"}
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
