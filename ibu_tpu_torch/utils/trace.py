"""Spans and counters inside the port, on the profiler's clock.

Tracing is on while a ``torch.profiler`` session is active, and only then;
nothing else turns it on. While it is off, :func:`span` returns one shared
no-op context and :func:`count` returns at once: one flag test each. While
it is on, each span is recorded in memory (:class:`Span`) and also entered
as ``torch.profiler.record_function(name)``, so it appears by name in the
profiler's trace. The tracer itself starts no kernel and waits on nothing:
counters hold sizes the host already knows, such as an array's ``nbytes``.

A span's parent is the innermost span open on the same thread; a span with
none is a root, one call into the port, and every span of that call carries
the root's index. :func:`session` returns the spans recorded since the
profiler session in progress, or the last one, began: the first root to find
the profiler on, after any span or read of :func:`session` found it off,
starts a new session.

Times are Unix nanoseconds (``time.time_ns``), the clock of the exported
Chrome trace: an event's ``ts`` plus ``baseTimeNanoseconds / 1000`` is in
the same microseconds. A recorded span lies inside its own profiler event.

Importing this module loads no torch: the profiler is looked up in
``sys.modules`` when a span opens, so host-only callers pay nothing.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import nullcontext

_PROFILER = "torch.autograd.profiler"

#: the context :func:`span` returns while tracing is off
OFF = nullcontext()


class Span:
    """One recorded span. ``start_ns``/``end_ns`` are Unix nanoseconds
    (``end_ns`` is 0 while the span is open); ``index``, ``parent`` and
    ``root`` are positions in :func:`session`'s list (``parent`` None for a
    root, whose ``root`` is its own ``index``); ``thread`` is the
    ``threading.get_ident()`` of the thread that opened it; ``counters``
    maps a counter's name to its sum inside this span and outside its
    children."""

    __slots__ = ("name", "index", "parent", "root", "thread", "start_ns", "end_ns", "counters")

    def __init__(self, name: str, index: int, parent: Span | None, thread: int):
        self.name = name
        self.index = index
        self.parent = None if parent is None else parent.index
        self.root = index if parent is None else parent.root
        self.thread = thread
        self.start_ns = 0
        self.end_ns = 0
        self.counters: dict[str, int] = {}

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Tracer:
    """The process's recorded session. One per process, as the profiler is."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans: list[Span] = []
        #: a span has found the profiler off since the session began
        self.stale = True

    def stack(self) -> list[Span]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_TRACER = _Tracer()


class _Open:
    __slots__ = ("name", "annotation", "span")

    def __init__(self, name: str, annotation):
        self.name = name
        self.annotation = annotation

    def __enter__(self) -> Span:
        self.annotation.__enter__()
        tracer = _TRACER
        stack = tracer.stack()
        with tracer.lock:
            if not stack and tracer.stale:
                tracer.spans, tracer.stale = [], False
            spans = tracer.spans
            span = Span(self.name, len(spans), stack[-1] if stack else None,
                        threading.get_ident())
            spans.append(span)
        stack.append(span)
        self.span = span
        span.start_ns = time.time_ns()
        return span

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.time_ns()
        _TRACER.stack().pop()
        self.annotation.__exit__(*exc)


def span(name: str):
    """A context that records the enclosed code as the span ``name`` while
    a profiler session is active, and :data:`OFF` otherwise."""
    profiler = sys.modules.get(_PROFILER)
    if profiler is None or not profiler._is_profiler_enabled:
        _TRACER.stale = True
        return OFF
    return _Open(name, profiler.record_function(name))


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span on this
    thread; nothing while tracing is off or outside every span."""
    profiler = sys.modules.get(_PROFILER)
    if profiler is None or not profiler._is_profiler_enabled:
        return
    stack = _TRACER.stack()
    if stack:
        counters = stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def session() -> list[Span]:
    """The spans of the profiler session in progress, or of the last one, in
    the order they opened. Read with the profiler off, it also ends that
    session: the next root to find the profiler on starts a new one."""
    profiler = sys.modules.get(_PROFILER)
    if profiler is None or not profiler._is_profiler_enabled:
        _TRACER.stale = True
    return list(_TRACER.spans)


def self_ns(spans: list[Span]) -> list[int]:
    """Each span's self time, for ``spans`` as :func:`session` returns them:
    its duration less its children's (children run on their parent's
    thread, one after another)."""
    out = [s.duration_ns for s in spans]
    for s in spans:
        if s.parent is not None:
            out[s.parent] -= s.duration_ns
    return out
