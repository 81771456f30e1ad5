"""The program's own spans in a traced run, read from a ``benchmark.trace.Trace``.

The port marks its layers with ``utils/profiling.py::span``: while the
profiler runs, a function-scope record function, which the Chrome trace
holds as a ``cpu_op`` event of the span's name, on the clock of the card's
events. ``Trace`` keeps such events among its ``ops``, so these readers
take them from there by name and leave every reading of ``Trace`` as it
was. A span counts when it lies wholly inside the traced window. A
program without these spans (an older checkout) gives no spans: every
reader here then returns None, 0 or an empty list, and none raises.

 - ``program_spans(tr, names)``: the spans of those names;
 - ``span_host_s(tr, names)``: host seconds those spans cover, their union
   on each thread, summed over threads;
 - ``device_ms_per_root(tr, names, root)``: device ms a ``root`` span (the
   union of the intervals) of the kernels, copies and sets whose launch
   call lies inside one of those spans and one ``root`` span on one thread
   (``Trace.under_op``'s rule), over the root spans whose every kernel ran
   inside the window: the host runs ahead of the card, so the last batch
   launched in the window runs on past its end, and the work of the
   window's first milliseconds was launched before it;
 - ``idle_under(tr, names, root)``: seconds of the window in which the card
   was idle while one of those spans was open on the thread that runs the
   ``root`` spans.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

from benchmark.trace import _union

Interval = Tuple[float, float]


def program_spans(tr, names: Iterable[str]) -> List[dict]:
    """The events of the spans named ``names`` that lie wholly in the window."""
    names = set(names)
    w0, w1 = tr.window
    return [o for o in tr.ops if o.get("name") in names
            and w0 <= float(o["ts"]) and float(o["ts"]) + float(o.get("dur", 0)) <= w1]


def _by_thread(spans: List[dict]) -> Dict[object, List[Interval]]:
    out: Dict[object, List[Interval]] = defaultdict(list)
    for s in spans:
        out[s["tid"]].append((float(s["ts"]), float(s["ts"]) + float(s.get("dur", 0))))
    return {tid: _union(iv) for tid, iv in out.items()}


def _inside(intervals: List[Interval], starts: List[float], t: float) -> bool:
    """Whether ``t`` lies in one of ``intervals`` (sorted, disjoint; ``starts``
    their starts)."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= intervals[i][1]


def _overlap(a: List[Interval], b: List[Interval]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_host_s(tr, names: Iterable[str]) -> float:
    return sum(b - a for iv in _by_thread(program_spans(tr, names)).values()
               for a, b in iv) / 1e6


def _launched_under(tr, names: Iterable[str]) -> List[Tuple[dict, Interval]]:
    """(launch call, device interval) of every kernel, copy and set whose
    launch call lies inside one of the spans ``names`` on its thread."""
    by_tid = _by_thread(program_spans(tr, names))
    starts = {tid: [a for a, _ in iv] for tid, iv in by_tid.items()}
    out = []
    for e in tr.device:
        api = tr.launch.get((e.get("args") or {}).get("correlation"))
        tid = None if api is None else api["tid"]
        if tid in by_tid and _inside(by_tid[tid], starts[tid], float(api["ts"])):
            a = float(e["ts"])
            out.append((api, (a, a + float(e.get("dur", 0)))))
    return out


def device_ms_per_root(tr, names: Iterable[str], root: str):
    kernels, under = _launched_under(tr, [root]), _launched_under(tr, names)
    done, mine = 0, []
    for r in program_spans(tr, [root]):
        r0, r1 = float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0))

        def of_r(api):
            return api["tid"] == r["tid"] and r0 <= float(api["ts"]) <= r1

        if any(b > tr.window[1] for api, (_, b) in kernels if of_r(api)):
            continue  # this root's work runs on past the window
        done += 1
        mine += [iv for api, iv in under if of_r(api)]
    return sum(b - a for a, b in _union(mine)) / 1e3 / done if done else None  # us -> ms


def _idle(tr) -> List[Interval]:
    """The window's intervals with no kernel, copy or set on the card."""
    w0, w1 = tr.window
    out, t = [], w0
    for a, b in _union([(a, b) for a, b, _ in tr._clipped()]):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def idle_under(tr, names: Iterable[str], root: str = "train.step") -> float:
    threads = {s["tid"] for s in program_spans(tr, [root])}
    by_tid = _by_thread([s for s in program_spans(tr, names) if s["tid"] in threads])
    idle = _idle(tr)
    return sum(_overlap(iv, idle) for iv in by_tid.values()) / 1e6


def per_root(tr, seconds: float, root: str):
    """``seconds`` in ms per ``root`` span of the window; None without one."""
    n = len(program_spans(tr, [root]))
    return 1e3 * seconds / n if n else None
