"""One run of one cell: set-up, the measured window, the trace, the check
against the plain reference, and the result line's contents.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name under the root of the checkout:

- ``BENCHMARK.json``: the cell, its configuration's file and which
  metrics it reports;
- the configuration file: the matrix builder (``benchmark/matrices/
  <builder>.py``) and its parameters, the solver's options and the
  guarantees;
- ``benchmark/traffic/<traffic>.json``: the op that a request runs
  (``benchmark/ops/<op>.py``) and its parameters;
- the cell's time metric: the one end-to-end metric of ``BENCHMARK.json``
  that lists the cell and whose unit is a time (``s``, ``ms`` or ``us``)
  besides ``setup_s``; its unit sets its scale;
- ``benchmark/limits/<cell>.json``: the limit of each number compared;
- ``benchmark/metrics/<metric>.py``: the reader of a per-layer metric.

A request runs to its end.  The window starts the first request at t0
and starts none after ``seconds``; the time metric is (end of the last
request - t0) / requests completed.  Besides the result, a run logs to
standard error each request's time and the host's own readings over the
window (its thread's CPU time, page faults, context switches, the
garbage collector's pauses, the machine's steal time), so that a spread
of runs can be traced to its cause.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import resource
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from .trace import Profiler, Trace

_NULL = contextlib.nullcontext()
TIME_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6}


def _load(path: str, modname: str):
    """The module at ``path`` (absolute imports of ``benchmark.*``
    resolve to this package)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """A cell of ``BENCHMARK.json`` with the files it names."""

    def __init__(self, root: str, cell: str):
        self.root = root
        self.bench = _read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
        self.cell = cells[cell]
        entry = {c["name"]: c for c in self.bench["configs"]}[
            self.cell["config"]]
        self.config = _read_json(os.path.join(root, entry["file"]))
        self.traffic = _read_json(self._path("traffic",
                                             self.cell["traffic"] + ".json"))
        self.limits = _read_json(self._path("limits", cell + ".json"))
        times = [m for m in self.bench["end_to_end"]
                 if m["name"] != "setup_s" and m["unit"] in TIME_UNITS
                 and self.reports(m)]
        if len(times) != 1:
            raise KeyError(f"{cell}: {len(times)} end-to-end time metrics "
                           f"list this cell, not one")
        self.time_metric = times[0]

    def _path(self, *parts) -> str:
        return os.path.join(self.root, "benchmark", *parts)

    def module(self, kind: str, name: str):
        return _load(self._path(kind, name + ".py"),
                     f"benchmark.{kind}.{name}")

    def reports(self, metric: dict) -> bool:
        return self.cell["name"] in metric.get("workloads",
                                               [self.cell["name"]])


class Context:
    """What an op sees: the cell's files, the matrix, the device, seeded
    random streams, the spans, set-up timings and facts of the work that
    the metric readers read.  ``cache`` (a dict kept by the caller, or
    None) carries the matrix and the plans from one run of a process to
    the next; only ``calibrate.py`` passes one."""

    def __init__(self, spec: Spec, seed: int, device: torch.device,
                 trace: bool, control: bool, cache: dict = None):
        self.spec = spec
        self.config, self.traffic = spec.config, spec.traffic
        self.seed = int(seed)
        self.device = device
        self.trace = trace
        self.control = control
        self.timings: Dict[str, float] = {}
        self.spans: list = []
        self.recording = False
        self.launches: Dict[str, list] = {}
        self.facts: Dict[str, float] = {}
        self._cache = cache
        builder = spec.module("matrices", self.config["matrix"]["builder"])
        self.A = self.cached("A", lambda: builder.build(
            self.config["matrix"], self.rng(0)))

    def cached(self, what: str, make: Callable):
        """``make()``, or what it made in an earlier run of this process
        on the same configuration, where the caller keeps a cache."""
        if self._cache is None:
            return make()
        key = (self.config["name"], what)
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def rng(self, stream: int) -> np.random.Generator:
        """The seed's random stream ``stream`` (0 the matrix, 1 the
        requests, 2 the check's probes, 3 the check's sample)."""
        return np.random.default_rng([self.seed % 2 ** 64, stream])

    def torch_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.seed % 2 ** 63)

    def span(self, name: str):
        """A span of the benchmark's own, kept in a traced run only."""
        return _Span(self.spans, name) if self.trace else _NULL

    def build_solver(self, make: Callable):
        """The solver ``make()`` builds on the matrix; its construction
        (the plan) is timed as ``plan_s``."""
        t = time.perf_counter()
        F = self.cached("solver", make)
        self.timings["plan_s"] = time.perf_counter() - t
        return F

    def enable_tf32(self) -> None:
        """The control's lower precision: float32 matrix products in
        TF32, where the configuration states TF32 off."""
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class _Span:
    __slots__ = ("spans", "name", "t")

    def __init__(self, spans: list, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t = time.time_ns()

    def __exit__(self, *exc):
        self.spans.append((self.name, self.t, time.time_ns()))


@contextlib.contextmanager
def _recording(ctx: Context, sites):
    """Wraps each (module, attribute) kernel wrapper of ``sites`` so that
    a launch made while ``ctx.recording`` keeps the shape of its last
    argument (chol_tiles: the tiles; trsm_tiles_batched: X)."""
    saved = []
    for mod, attr in sites:
        fn = getattr(mod, attr)
        shapes = ctx.launches.setdefault(attr, [])

        def wrapped(*args, _fn=fn, _shapes=shapes):
            if ctx.recording and args[-1].shape[0]:
                _shapes.append(tuple(args[-1].shape))
            return _fn(*args)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _restore_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def run_cell(root: str, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             control: bool = False, cache: dict = None,
             log: Callable[[str], None] = None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``control`` puts the cell's control in the program's place and
    ``cache`` keeps the matrix and plans for the next run (only
    ``calibrate.py`` and the tests set them)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = Spec(root, cell)
    dev = torch.device(device)
    ctx = Context(spec, seed, dev, bool(trace), control, cache)
    op = spec.module("ops", spec.traffic["op"])
    sites = getattr(op, "KERNEL_SITES", ()) if trace else ()
    try:
        with _recording(ctx, sites):
            return _run(ctx, op, seconds, t_start, log)
    finally:
        _restore_precision()


def _run(ctx: Context, op, seconds: float, t_start: float,
         log: Callable[[str], None]) -> dict:
    spec, traffic = ctx.spec, ctx.traffic
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    state = op.setup(ctx)
    ctx.sync()
    tr = Trace(cell=spec.cell["name"], timings=ctx.timings,
               spans=ctx.spans, launches=ctx.launches, facts=ctx.facts,
               traced_device=ctx.trace and ctx.device.type == "cuda")
    # a traced run profiles ``trace_requests`` requests from the middle of
    # the window on: the host spans before them are free of the
    # profiler's cost, which stays on the process after it stops
    prof = Profiler(ctx.device) if ctx.trace else None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline, trace_from = t0 + seconds, t0 + seconds / 2
    attempted = failed = traced = 0
    ends, cpu = [], []
    host = _HostMeter()
    while time.perf_counter() < deadline:
        if prof and not tr.t0 and time.perf_counter() >= trace_from:
            op.finish(ctx, state)
            tr.t0, ctx.recording = prof.start(), True
        ok = op.request(ctx, state)
        ends.append(time.perf_counter())
        cpu.append(time.thread_time())
        attempted += 1
        failed += not ok
        traced += ctx.recording
        if ctx.recording and traced == traffic["trace_requests"]:
            tr.t1, tr.events = prof.stop()
            tr.requests, ctx.recording = traced, False
    op.finish(ctx, state)
    ctx.sync()
    t1 = time.perf_counter()
    host.stop()
    if ctx.recording:
        tr.t1, tr.events = prof.stop()
        tr.requests, ctx.recording = traced, False
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    _log_window(log, t0, t1, ends, cpu, host, tr if prof else None)
    outputs = op.collect(ctx, state)
    del state
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings = op.check(ctx, outputs)
    log(f"check took {time.perf_counter() - t_check:.3f} s (reference)")
    checks = {}
    for name, value in readings.items():
        limit = ctx.spec.limits.get(name)
        if limit is None:
            limit = ctx.config["guarantees"][name]
        checks[name] = {"value": value, "limit": limit}
    correct = (attempted > 0 and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    tm = spec.time_metric
    e2e = {"setup_s": setup_s, "peak_mib": peak / 2 ** 20,
           tm["name"]: (t1 - t0) / max(attempted, 1) * TIME_UNITS[tm["unit"]]}
    metrics = {}
    if ctx.trace:
        for m in spec.bench["per_layer"]:
            if spec.reports(m):
                reader = spec.module("metrics", m["name"])
                v = reader.read(tr)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.bench["end_to_end"]:
            if spec.reports(m):
                if m["name"] not in e2e:
                    raise KeyError(f"{m['name']}: this cell's op does not "
                                   f"measure it")
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": _device(ctx, spec, peak, tr)}
    if ctx.trace and tr.traced_device:
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


class _HostMeter:
    """The host's readings over the window: this thread's CPU time, the
    process's page faults and context switches, the garbage collector's
    collections and pauses, and the machine's steal time."""

    def __init__(self):
        self.gc = {"n": 0, "gen2": 0, "s": 0.0, "t": 0.0}
        gc.callbacks.append(self._gc)
        self.a = self._read()

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.gc["t"] = time.perf_counter()
        else:
            self.gc["n"] += 1
            self.gc["gen2"] += info["generation"] == 2
            self.gc["s"] += time.perf_counter() - self.gc["t"]

    @staticmethod
    def _read() -> tuple:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        try:
            with open("/proc/stat") as f:
                steal = int(f.readline().split()[8]) / os.sysconf(
                    "SC_CLK_TCK")
        except (OSError, IndexError, ValueError):
            steal = float("nan")
        return (time.perf_counter(), time.thread_time(), ru.ru_minflt,
                ru.ru_nvcsw, ru.ru_nivcsw, steal)

    def stop(self) -> None:
        self.b = self._read()
        gc.callbacks.remove(self._gc)

    def line(self) -> str:
        d = [b - a for a, b in zip(self.a, self.b)]
        return (f"host in the window: thread cpu {d[1]:.3f} s of "
                f"{d[0]:.3f} s wall; {d[2]} minor faults; {d[3]} voluntary"
                f", {d[4]} involuntary switches; gc {self.gc['n']} "
                f"collections ({self.gc['gen2']} full) {self.gc['s']:.3f}"
                f" s; machine steal {d[5]:.2f} cpu-s")


def _log_window(log, t0: float, t1: float, ends: list, cpu: list,
                host: _HostMeter, tr) -> None:
    """Request times (the first apart, to show warm-up left in the
    window), the host's readings and, in a traced run, how the trace's
    events sit in its window."""
    if ends:
        d = [b - a for a, b in zip([t0] + ends[:-1], ends)]
        srt = sorted(d)
        log(f"window {t1 - t0:.6f} s, {len(d)} requests; first "
            f"{d[0]:.6f} s, min {srt[0]:.6f}, median {srt[len(d) // 2]:.6f}"
            f", max {srt[-1]:.6f}; after the last {t1 - ends[-1]:.6f} s")
        if len(d) <= 64:
            c = [b - a for a, b in zip([host.a[1]] + cpu[:-1], cpu)]
            log("request s: " + " ".join(f"{x:.4f}" for x in d))
            log("request thread cpu s: " + " ".join(f"{x:.4f}" for x in c))
    log(host.line())
    if tr is not None:
        out = sum(1 for _, s, e in tr.events if s < tr.t0 or e > tr.t1)
        log(f"trace: {len(tr.events)} device events ({out} outside the "
            f"traced window) in {tr.window_s():.6f} s over {tr.requests} "
            f"requests")


def _device(ctx: Context, spec: Spec, peak: int, tr: Trace) -> dict:
    if ctx.device.type == "cuda":
        d = {"platform": "gpu",
             "kind": torch.cuda.get_device_name(ctx.device),
             "count": int(spec.cell["chips"]), "memory_peak_bytes": peak}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": peak}
    if ctx.trace:
        d["busy_s"] = tr.busy_s()
        d["window_s"] = tr.window_s()
    return d


def check_lines(result: dict) -> list:
    """One line per number compared, with its limit."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for name, c in result["checks"].items()]


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that a run may not load: JAX,
    its libraries and the JAX package, compared whole."""
    bad = {"jax", "jaxlib", "flax", "tpusparse"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & bad)

