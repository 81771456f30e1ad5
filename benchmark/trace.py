"""The traced run: a ``torch.profiler`` window and what is read from it.

``Tracer`` profiles a short steady part of a run's window (CPU ops with
their input shapes, and the card's kernels, copies and sets). The part is
marked by the benchmark's own range ``bench.window``; spans of the
benchmark's own (``span``) name what the host did. ``Trace`` reads the
exported Chrome trace:

 - device intervals (kernels, memcpy, memset) and their union inside the
   window: ``busy_s`` and ``window_s``;
 - the kernels launched under a CPU op's range (a custom op of the
   program, say), linked through each launch's correlation id to the host
   call that issued it, with that op's input shapes;
 - the longest device operations by name and the longest idle gaps, each
   gap named by the benchmark span (or else the outermost program op) open
   on the host at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A host span of the benchmark's own, seen by the profiler when on."""
    with torch.profiler.record_function(name):
        yield


class Tracer:
    """Profile between ``start()`` and ``stop()``; ``finish()``, once the
    window has closed, reads that part into a ``Trace``. Inactive (every
    call a no-op) when ``enabled`` is false."""

    def __init__(self, enabled: bool, path: str):
        self.enabled, self.path = enabled, path
        self.prof = None
        self.window = None
        self.trace: Optional[Trace] = None

    def start(self) -> None:
        if not self.enabled or self.prof is not None or self.trace is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts, record_shapes=True)
        self.prof.start()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()

    def stop(self) -> None:
        """End the profiled part (after the card has finished its work)."""
        if self.prof is None or self.window is None:
            return
        self.window.__exit__(None, None, None)
        self.window = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def finish(self) -> Optional["Trace"]:
        """Read what was profiled (once the run's window has closed)."""
        if self.prof is None:
            return self.trace
        self.stop()
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        with open(self.path) as f:
            self.trace = Trace(json.load(f))
        os.remove(self.path)
        return self.trace


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """What a Chrome trace of ``torch.profiler`` holds, in microseconds."""

    def __init__(self, doc: dict):
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        self.device: List[dict] = []
        self.ops: List[dict] = []
        self.spans: List[dict] = []
        self.launch: Dict[int, dict] = {}
        self.window: Optional[Tuple[float, float]] = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat in _DEVICE_CATS:
                self.device.append(e)
            elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                self.launch[args["correlation"]] = e
            elif cat == "cpu_op":
                self.ops.append(e)
            elif cat == "user_annotation" and e.get("name", "").startswith("bench."):
                if e["name"] == WINDOW:
                    self.window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                else:
                    self.spans.append(e)
        if self.window is None:
            raise ValueError("the trace has no bench.window range")

    # -- the device's time --------------------------------------------------------
    def _clipped(self) -> List[Tuple[float, float, dict]]:
        w0, w1 = self.window
        out = []
        for e in self.device:
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            a, b = max(a, w0), min(b, w1)
            if b > a:
                out.append((a, b, e))
        return out

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in _union([(a, b) for a, b, _ in self._clipped()])) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        """[[name, seconds]] of the device operations that took most time."""
        tot: Dict[str, float] = defaultdict(float)
        for a, b, e in self._clipped():
            tot[e.get("name", "?")] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[[what the host was doing, seconds]] of the longest idle gaps."""
        w0, w1 = self.window
        busy = _union([(a, b) for a, b, _ in self._clipped()])
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_doing((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:top]]

    def host_doing(self, t: float) -> str:
        """The innermost benchmark span open at ``t``, else the outermost
        program op, else ``host: no op``."""
        open_spans = [s for s in self.spans if s["ts"] <= t <= s["ts"] + s["dur"]]
        if open_spans:
            return max(open_spans, key=lambda s: s["ts"])["name"]
        open_ops = [o for o in self.ops if o["ts"] <= t <= o["ts"] + o["dur"]]
        if open_ops:
            return "op " + min(open_ops, key=lambda o: o["ts"])["name"]
        return "host: no op"

    # -- kernels under an op --------------------------------------------------------
    def under_op(self, op_name: str) -> List[Tuple[list, float]]:
        """[(input dims of the op call, device seconds of the kernels it
        launched)] for every call of ``op_name`` that launched any inside
        the window. A kernel belongs to the call whose host range holds,
        on the same thread, the API call that launched it."""
        w0, w1 = self.window
        calls = sorted((o for o in self.ops if o.get("name") == op_name
                        and w0 <= o["ts"] <= w1), key=lambda o: (o["tid"], o["ts"]))
        by_tid: Dict[object, List[dict]] = defaultdict(list)
        for o in calls:
            by_tid[o["tid"]].append(o)
        starts = {tid: [o["ts"] for o in os_] for tid, os_ in by_tid.items()}
        dev: Dict[int, float] = defaultdict(float)
        for e in self.device:
            corr = (e.get("args") or {}).get("correlation")
            api = self.launch.get(corr)
            if api is None or api["tid"] not in by_tid:
                continue
            i = bisect.bisect_right(starts[api["tid"]], api["ts"]) - 1
            if i < 0:
                continue
            o = by_tid[api["tid"]][i]
            if api["ts"] <= o["ts"] + o["dur"]:
                dev[id(o)] += float(e.get("dur", 0)) / 1e6
        return [((o.get("args") or {}).get("Input Dims", []), dev[id(o)])
                for o in calls if dev.get(id(o))]
