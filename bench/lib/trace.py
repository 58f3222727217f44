"""Reading a ``torch.profiler`` trace of the measured window.

``Traced`` runs the window under the profiler (host and device activity)
and reduces the trace to what the per-layer readers and the result line
need: every device event inside the window (kernels, copies, fills) with
its name and seconds, the device's busy seconds (the union of those
events), the window's length, and the idle gaps named by what the host
was doing then.  The window is the span of the benchmark's own
``bench.window`` record, so host and device times share one clock.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, Tuple

WINDOW_SPAN = "bench.window"
#: a trace that comes back with no device event is taken again, this many
#: times in all (a short trace on the card sometimes comes back empty)
TRIES = 3


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, float]]      # (name, seconds) of device events
    window_s: float
    busy_s: float
    idle_by_host: List[Tuple[str, float]]  # (host activity, idle seconds)

    def seconds(self, match: Callable[[str], bool]) -> float:
        return sum(s for n, s in self.kernels if match(n))

    def count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _ in self.kernels if match(n))

    def top_ops(self, n: int = 10) -> list:
        per = {}
        for name, s in self.kernels:
            key = name[:120]
            per[key] = per.get(key, 0.0) + s
        return [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_at(starts, cpu, t: float) -> str:
    """The innermost host op running at ``t`` (looked for among the 400
    that started last before it)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 401), -1):
        s, e, name = cpu[j]
        if e >= t and name != WINDOW_SPAN and (
                best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "host idle"


def reduce_events(events) -> Trace:
    """The window's device events, busy seconds and idle gaps from a
    profiler's ``events()``."""
    from torch.autograd import DeviceType
    win = None
    dev, cpu = [], []
    for evt in events:
        tr = evt.time_range
        if evt.name.startswith("bench."):
            # the benchmark's own records, on the host and, as annotations,
            # on the device's timeline too: only the host's window counts
            if evt.name == WINDOW_SPAN and evt.device_type != DeviceType.CUDA:
                win = (tr.start, tr.end)
            if evt.device_type != DeviceType.CUDA:
                cpu.append((tr.start, tr.end, evt.name))
            continue
        if evt.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, evt.name))
        else:
            cpu.append((tr.start, tr.end, evt.name))
    if win is None:
        raise RuntimeError("the trace holds no bench.window span")
    lo, hi = win
    inside = [(max(s, lo), min(e, hi), n) for s, e, n in dev
              if e > lo and s < hi]
    kernels = [(n, (e - s) * 1e-6) for s, e, n in inside]
    merged = _merge([[s, e] for s, e, _ in inside])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:5000]:
        name = _host_at(starts, cpu, 0.5 * (s + e))[:120]
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    return Trace(kernels=kernels, window_s=(hi - lo) * 1e-6, busy_s=busy,
                 idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]))


def traced(run: Callable[[], object], cuda: bool = True):
    """(what ``run`` returns, its ``Trace``): ``run`` is the window, which
    opens the ``bench.window`` record itself.  Taken again when the trace
    holds no device event, up to ``TRIES`` times (``cuda`` False: a CPU
    rehearsal, traced once, host activity only)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(TRIES if cuda else 1):
        with profile(activities=acts) as prof:
            out = run()
        trace = reduce_events(prof.events())
        if trace.kernels:
            break
    return out, trace
