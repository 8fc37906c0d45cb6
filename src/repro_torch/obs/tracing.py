"""Span-based tracer: monotonic-clock timings with nesting.

``Tracer.span(name)`` is a context manager; ``Tracer.trace(name)`` the
decorator form.  Finished spans land in two places: their duration is
observed into the registry histogram ``span.<name>`` (so percentiles
accumulate across the run), and a ``SpanRecord`` is appended to the
per-round buffer that ``drain()`` empties — the trainers drain once per
round to attach a ``phases`` breakdown to the round record.

Disabled tracers return the module-level ``NULL_SPAN`` singleton whose
``__enter__``/``__exit__`` do nothing: the cost of an off span is one
attribute check, no allocation, no clock read.
"""
from __future__ import annotations

import dataclasses
import functools
from time import perf_counter
from typing import Dict, List, Optional


@dataclasses.dataclass
class SpanRecord:
    name: str
    depth: int          # 0 = root; children appear before their parent
    seconds: float
    tags: Optional[Dict] = None


class _NullSpan:
    """Shared no-op span (disabled tracer)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "tags", "t0")

    def __init__(self, tracer: "Tracer", name: str, tags: Optional[Dict]):
        self._tracer = tracer
        self.name = name
        self.tags = tags

    def __enter__(self):
        self._tracer._depth += 1
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = perf_counter() - self.t0
        tr = self._tracer
        tr._depth -= 1
        tr.records.append(SpanRecord(self.name, tr._depth, seconds,
                                     self.tags))
        tr.registry.histogram("span." + self.name).observe(seconds)
        return False


class Tracer:
    __slots__ = ("enabled", "registry", "records", "_depth")

    def __init__(self, registry, enabled: bool = True):
        self.enabled = enabled
        self.registry = registry
        self.records: List[SpanRecord] = []
        self._depth = 0

    def span(self, name: str, **tags):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, tags or None)

    def trace(self, name: str):
        """Decorator form — the enabled check happens per call, so a
        function decorated while tracing is off becomes live the moment
        the tracer is enabled."""
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                if not self.enabled:
                    return fn(*args, **kwargs)
                with self.span(name):
                    return fn(*args, **kwargs)
            return wrapper
        return deco

    def drain(self) -> List[SpanRecord]:
        """Return and clear the span buffer (per-round flush)."""
        out, self.records = self.records, []
        return out
