"""The device trace of a run's traced requests, and its arithmetic.

``torch.profiler`` records the device activities (kernels, copies, sets)
of ``trace_requests`` requests from the middle of a ``--trace 1`` window
on; the benchmark's own
spans (``time.time_ns()``, the clock the profiler stamps its events
with) say what the host was doing.  The busy time is the union of the
activity intervals inside the traced window, which counts copies and
sets and overlapping streams once; ``chip_smoke.py::_profile_summary``
summed kernel self times instead (the idea frozen here, the source
widened).  Only ``CUDA`` activities are recorded, so the host's own ops
add no events: one factor of the large cells is ~150 k of them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

Event = Tuple[str, int, int]        # (name, start ns, end ns)
Span = Tuple[str, int, int]


@dataclass
class Trace:
    """What the metric readers read.  ``t0``..``t1`` (ns) is the traced
    window, which holds ``requests`` requests; ``events`` are
    its device activities, ``spans`` the benchmark's spans of the whole
    window, ``launches`` the shapes of the kernel launches recorded in
    the traced window ({wrapper name: [shape of its last argument]}),
    ``timings`` the set-up's host-clock readings (s), ``facts`` what an
    op states of its work (a matrix's rows and entries)."""
    cell: str
    t0: int = 0
    t1: int = 0
    requests: int = 0
    events: List[Event] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    launches: Dict[str, list] = field(default_factory=dict)
    timings: Dict[str, float] = field(default_factory=dict)
    facts: Dict[str, float] = field(default_factory=dict)
    traced_device: bool = False

    # ---------------------------------------------------------- device
    def merged(self) -> List[Tuple[int, int]]:
        """Union of the device activity intervals, clipped to the
        window, in order."""
        out: List[List[int]] = []
        for _, s, e in sorted(self.events, key=lambda ev: ev[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> Optional[float]:
        if not self.traced_device:
            return None
        return sum(e - s for s, e in self.merged()) / 1e9

    def idle_share(self) -> Optional[float]:
        busy = self.busy_s()
        if not busy:
            return None
        return 1.0 - busy / self.window_s()

    def ops_per_request(self) -> Optional[float]:
        if not self.traced_device or not self.events or not self.requests:
            return None
        return len(self.events) / self.requests

    def kernel(self, name: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        ``name``."""
        hits = [e - s for n, s, e in self.events if name in n]
        return len(hits), sum(hits) / 1e9

    # ------------------------------------------------------------ host
    def spans_before(self, name: str) -> List[float]:
        """Seconds of each ``name`` span that ended before the traced
        window (free of the profiler's cost); all of them where none
        did."""
        all_ = [(s, e) for n, s, e in self.spans if n == name]
        early = [(s, e) for s, e in all_ if e <= self.t0]
        return [(e - s) / 1e9 for s, e in (early or all_)]

    def label(self, t: int, spans: List[Span]) -> str:
        """The innermost of ``spans`` open at ``t``."""
        best = None
        for n, s, e in spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (n, s)
        return best[0] if best else "between requests"

    # ------------------------------------------------------- breakdown
    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps of the traced window, each gap named by the span open at
        its middle."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.events:
            key = n[:120]
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0]
        for s, e in self.merged():
            edges += [s, e]
        edges.append(self.t1)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        inside = [sp for sp in self.spans
                  if sp[1] < self.t1 and sp[2] > self.t0]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self.label(s + d // 2, inside), d / 1e9]
                              for d, s in gaps]}


class Profiler:
    """Starts and stops ``torch.profiler`` around the traced requests
    (device activities only) and turns its raw results into events."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._prof = None

    def start(self) -> int:
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.synchronize()
        return time.time_ns()

    def stop(self) -> Tuple[int, List[Event]]:
        if not self.cuda:
            return time.time_ns(), []
        torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == cuda and e.duration_ns() > 0]
        self._prof = None
        return t1, events

