"""Span-based tracer: nested spans on the profiler's clock.

``Tracer.span(name)`` is a context manager; ``Tracer.trace(name)`` the
decorator form; ``Tracer.device_span(name, device)`` a span that on a
CUDA device also records a ``torch.cuda.Event`` at each end.  A finished
span lands in two places: its duration (``perf_counter``) is observed
into the registry histogram ``span.<name>`` (so percentiles accumulate
across the run), and a ``SpanRecord`` is appended to the span buffer
that ``drain()`` empties — the trainers drain once per round to attach
the round's spans to its record.

A record carries its start and end as Unix-epoch nanoseconds
(``time.time_ns``), the time base of ``torch.profiler``'s kineto events,
so a reader can lay spans over a device trace, and the index of its
enclosing span (``parent``) in the list ``drain()`` or ``spans()``
returns.  While a profiler records, a live span also opens the
``record_function`` range ``obs:<name>``, so a trace opened in Perfetto
shows the phases.

A tracer is live while ``enabled``, or, with ``follows_profiler`` (the
process-wide ``DEFAULT`` facade), while a profiler records.  A tracer
that is not live returns the module-level ``NULL_SPAN`` singleton whose
``__enter__``/``__exit__`` do nothing: the cost of an off span is an
attribute check (two for a tracer that follows the profiler), no
allocation, no clock read.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from time import perf_counter, time_ns
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler


def profiling() -> bool:
    """True while a ``torch.profiler`` (or autograd profiler) session
    records."""
    return _autograd_profiler._is_profiler_enabled


def _record_function(name: str):
    return _autograd_profiler.record_function(name)


def _cuda_event():
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@dataclasses.dataclass
class SpanRecord:
    name: str
    depth: int          # 0 = root; children appear before their parent
    seconds: float      # perf_counter duration
    tags: Optional[Dict] = None
    t0_ns: int = 0      # Unix-epoch ns (time.time_ns), the profiler's clock
    t1_ns: int = 0
    parent: Optional[int] = None    # index of the enclosing span in the
    #   same drain, None for a root (or a parent not in that list)
    events: Optional[tuple] = None  # (start, end) torch.cuda.Event pair
    _seq: int = dataclasses.field(default=0, repr=False)
    _parent_seq: Optional[int] = dataclasses.field(default=None, repr=False)

    @property
    def device_s(self) -> Optional[float]:
        """Device seconds between the span's two CUDA events (None for a
        span with no device events, as on the CPU).  Resolved when read,
        so the traced code itself never waits for the device."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end) / 1e3


class _NullSpan:
    """Shared no-op span (tracer not live)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "tags", "cuda", "seq", "parent_seq",
                 "depth", "t0", "t0_ns", "ev0", "_rf", "_second")

    def __init__(self, tracer: "Tracer", name: str, tags: Optional[Dict],
                 cuda: bool = False):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self.cuda = cuda

    def __enter__(self):
        tr = self._tracer
        self._rf = None
        if profiling():
            self._rf = _record_function("obs:" + self.name)
            self._rf.__enter__()
        self.seq = tr._next_seq()
        self.parent_seq = tr._open[-1].seq if tr._open else None
        self.depth = len(tr._open)
        self._second = None
        tr._open.append(self)
        self.ev0 = _cuda_event() if self.cuda else None
        self.t0_ns = time_ns()
        self.t0 = perf_counter()
        return self

    def split(self, first: str, second: str) -> None:
        """End, at this instant, a child span ``first`` that began with
        this span, and begin a child ``second`` that ends with it (one
        device mark between the two on a CUDA span; the two open no
        profiler range of their own).  Called from a gradient hook while
        the span is open; only the first call splits."""
        if self._second is not None:
            return
        t, t_ns = perf_counter(), time_ns()
        ev = _cuda_event() if self.cuda else None
        tr = self._tracer
        tr._add(SpanRecord(first, self.depth + 1, t - self.t0, None,
                           self.t0_ns, t_ns, None,
                           (self.ev0, ev) if self.cuda else None,
                           tr._next_seq(), self.seq))
        self._second = (second, tr._next_seq(), t, t_ns, ev)

    def __exit__(self, *exc):
        t1 = perf_counter()
        t1_ns = time_ns()
        ev1 = _cuda_event() if self.cuda else None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        tr = self._tracer
        tr._open.pop()
        if self._second is not None:
            name, seq, t, t_ns, ev = self._second
            tr._add(SpanRecord(name, self.depth + 1, t1 - t, None, t_ns,
                               t1_ns, None,
                               (ev, ev1) if self.cuda else None, seq,
                               self.seq))
        tr._add(SpanRecord(self.name, self.depth, t1 - self.t0, self.tags,
                           self.t0_ns, t1_ns, None,
                           (self.ev0, ev1) if self.cuda else None,
                           self.seq, self.parent_seq))
        return False


class Tracer:
    __slots__ = ("enabled", "follows_profiler", "registry", "records",
                 "_open", "_seq")

    def __init__(self, registry, enabled: bool = True,
                 follows_profiler: bool = False, ring: Optional[int] = None):
        self.enabled = enabled
        self.follows_profiler = follows_profiler
        self.registry = registry
        # a bounded ring where nobody drains (the process-wide facade)
        self.records = collections.deque(maxlen=ring)
        self._open: List[_Span] = []
        self._seq = 0

    @property
    def live(self) -> bool:
        return self.enabled or (self.follows_profiler and profiling())

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _add(self, rec: SpanRecord) -> None:
        self.records.append(rec)
        self.registry.histogram("span." + rec.name).observe(rec.seconds)

    def span(self, name: str, **tags):
        if not self.live:
            return NULL_SPAN
        return _Span(self, name, tags or None)

    def device_span(self, name: str, device, **tags):
        """``span`` that, on a CUDA ``device``, also records a CUDA event
        at each end (``SpanRecord.device_s``)."""
        if not self.live:
            return NULL_SPAN
        return _Span(self, name, tags or None, device.type == "cuda")

    def split_hook(self, span: str, first: str, second: str):
        """A tensor gradient hook that splits the innermost open span, if
        it is named ``span``, into ``first`` and ``second`` at the
        instant the gradient arrives (``_Span.split``)."""
        def hook(grad):
            top = self._open[-1] if self._open else None
            if top is not None and top.name == span:
                top.split(first, second)
        return hook

    def grad_span_hooks(self, name: str, device):
        """(begin, end): tensor gradient hooks that open a span ``name``
        (with CUDA events on a CUDA ``device``) when the first fires and
        close it when the second fires, each once: a span of the backward
        between two tensors' gradients.  The spans that open meanwhile
        (a recompute's) are its children."""
        span = _Span(self, name, None, device.type == "cuda")
        state = []

        def begin(grad):
            if not state:
                state.append(span.__enter__())

        def end(grad):
            if len(state) == 1:
                state.append(span.__exit__(None, None, None))
        return begin, end

    def trace(self, name: str):
        """Decorator form — the live check happens per call, so a
        function decorated while tracing is off becomes live the moment
        the tracer is."""
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)
            return wrapper
        return deco

    def spans(self) -> List[SpanRecord]:
        """The buffered spans, oldest first, each ``parent`` the index of
        its enclosing span in this list (the buffer is left as it is)."""
        recs = list(self.records)
        index = {r._seq: i for i, r in enumerate(recs)}
        return [dataclasses.replace(r, parent=index.get(r._parent_seq))
                for r in recs]

    def drain(self) -> List[SpanRecord]:
        """Return and clear the span buffer (per-round flush)."""
        out = self.spans()
        self.records.clear()
        return out
