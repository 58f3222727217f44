"""Spans of the port's layers, on the profiler's clock.

``span(name)`` marks one layer's work on the host.  It records only while
a ``torch.profiler`` profile records in the calling thread
(``torch.autograd._profiler_enabled()``); otherwise it returns one shared
no-op and costs the one check.  So tracing is on exactly where an
operator (or a benchmark's traced run) profiles the program, and there is
no other switch.

While on, a span enters the profiler's fast record function, so it lies
on the profiler's host timeline beside the CUDA events (it is not a user
annotation, and puts nothing on the device's timeline), and on exit it
appends a ``Record`` to a bounded in-memory ring: its name, its start and
end on the Unix-epoch clock in ns (the clock the profiler converts its
events to), the id of the innermost span open around it (``parent``), the
id of the outermost (``request``: every span of one request or step
shares it) and the counts given to ``add``.  ``records()`` reads the ring.

    with tracing.span("server.copy_in") as s:
        x = x.to(device)
        s.add("h2d_bytes", x.nbytes)
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["Record", "span", "records", "CAPACITY"]

#: records the ring keeps: 16 times the longest traced window of the
#: benchmark (two seconds of ranking on an H100, ~1,000 requests of seven
#: spans each, records ~7,000)
CAPACITY = 1 << 17


@dataclasses.dataclass(slots=True)
class Record:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]      # id of the innermost span open around it
    request: int               # id of the outermost (its own for a root)
    counts: Dict[str, int]


class _Open(threading.local):
    def __init__(self):
        self.spans = []


_OPEN = _Open()
_RING: collections.deque = collections.deque(maxlen=CAPACITY)
_IDS = itertools.count()


class _Off:
    """What ``span`` returns while no profiler records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, key: str, n: int) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "counts", "start_ns",
                 "_rf")

    def __init__(self, name: str):
        self.name = name
        self.counts: Dict[str, int] = {}

    def add(self, key: str, n: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + int(n)

    def __enter__(self):
        stack = _OPEN.spans
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.request = stack[0].id if stack else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        end = time.time_ns()
        _OPEN.spans.pop()
        _RING.append(Record(self.name, self.start_ns, end, self.id,
                            self.parent, self.request, self.counts))
        return False


def span(name: str):
    """A context manager over one layer's work: records while a profiler
    records (``torch.autograd._profiler_enabled()``), else the shared
    no-op.  Either has ``add(key, n)``, which adds ``n`` to the span's
    count ``key``."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def records() -> List[Record]:
    """The ring's records, oldest first (each appended when its span
    ended, so a child comes before its parent)."""
    return list(_RING)
