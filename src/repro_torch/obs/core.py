"""The ``Obs`` facade: one tracer + one registry + the sink fan-out.

Trainers hold an ``Obs`` built by ``from_config(FLConfig.obs)``.  With
observability off (the default) that is the shared ``DISABLED``
singleton: ``span()`` returns the no-op null span, ``instrument_jit``
returns the callable unchanged, and every emit helper is guarded by
``if obs.enabled`` at the call site — the fault-free round is
bitwise-identical to the uninstrumented trainer and pays no measurable
per-round cost.

``DEFAULT`` is the process-wide facade used by library code that has no
trainer handle (e.g. ``core.scheduling.solve_many`` when called without
``obs=``).  It starts disabled; ``enable_default()`` arms it.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

from repro_torch.obs.config import ObsConfig
from repro_torch.obs.metrics import Registry
from repro_torch.obs.sinks import ConsoleSink, JSONLSink, MemorySink
from repro_torch.obs.tracing import Tracer


class Obs:
    def __init__(self, enabled: bool = True,
                 registry: Optional[Registry] = None, sinks=()):
        self.enabled = enabled
        self.metrics = registry if registry is not None else Registry()
        self.tracer = Tracer(self.metrics, enabled=enabled)
        self.sinks = list(sinks)

    # ------------------------------------------------------------------
    # tracing
    def span(self, name: str, **tags):
        return self.tracer.span(name, **tags)

    def trace(self, name: str):
        return self.tracer.trace(name)

    # ------------------------------------------------------------------
    # call tracking
    def instrument_jit(self, name: str, fn):
        """Wrap a round-core callable to count its calls
        (``calls.<name>``).  PyTorch runs eagerly, so there is no compile
        to count.  When disabled, returns ``fn`` unchanged — zero
        indirection on the hot path."""
        if not self.enabled:
            return fn
        reg = self.metrics

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            reg.counter(f"calls.{name}").inc()
            return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn
        return wrapped

    # ------------------------------------------------------------------
    # sinks
    def emit(self, record: Dict) -> None:
        for sink in self.sinks:
            sink.emit(record)

    def round_record(self, record: Dict) -> Dict:
        """Attach the drained span breakdown to ``record`` and emit it.

        ``phases`` maps each depth-1 span name to its summed seconds;
        ``round_s`` is the enclosing depth-0 ``round`` span's duration,
        so consumers can check that the phases cover the round."""
        phases: Dict[str, float] = {}
        round_s = None
        for s in self.tracer.drain():
            if s.depth == 0 and s.name == "round":
                round_s = s.seconds
            elif s.depth == 1:
                phases[s.name] = phases.get(s.name, 0.0) + s.seconds
        out = dict(record)
        out.setdefault("kind", "round")
        if phases:
            out["phases"] = phases
        if round_s is not None:
            out["round_s"] = round_s
        self.emit(out)
        return out

    def records(self) -> List[Dict]:
        """Records held by the first memory sink ([] if none)."""
        for sink in self.sinks:
            if isinstance(sink, MemorySink):
                return sink.records()
        return []

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()


# Shared no-op facade for every obs-disabled trainer.  Never written to
# (all writers guard on ``enabled``), so sharing is safe.
DISABLED = Obs(enabled=False)

# Process-wide facade for code without a trainer handle.  Disabled
# until ``enable_default()``.
DEFAULT = Obs(enabled=False)


def enable_default(sinks=()) -> Obs:
    """Arm the process-wide ``DEFAULT`` facade (idempotent)."""
    DEFAULT.enabled = True
    DEFAULT.tracer.enabled = True
    for s in sinks:
        DEFAULT.sinks.append(s)
    return DEFAULT


def from_config(cfg: Optional[ObsConfig]) -> Obs:
    """Build a facade from ``FLConfig.obs`` (the shared ``DISABLED``
    singleton when off — no per-trainer state at all)."""
    if cfg is None or not cfg.enabled:
        return DISABLED
    sinks = []
    if cfg.ring_size:
        sinks.append(MemorySink(cfg.ring_size))
    if cfg.jsonl_path is not None:
        sinks.append(JSONLSink(cfg.jsonl_path))
    if cfg.console:
        sinks.append(ConsoleSink())
    return Obs(enabled=True, sinks=sinks)
