"""The ``Obs`` facade: one tracer + one registry + the sink fan-out.

Trainers hold an ``Obs`` built by ``from_config(FLConfig.obs)``.  With
observability off (the default) that is the shared ``DISABLED``
singleton: ``span()`` returns the no-op null span, in every case, and
every emit helper is guarded by ``if obs.enabled`` at the call site —
the fault-free round is bitwise-identical to the uninstrumented trainer
and pays no measurable per-round cost.

``DEFAULT`` is the process-wide facade used by library code that has no
trainer handle (``core.scheduling.solve_many`` when called without
``obs=``, the LM train step of ``fl.distributed.make_train_step``).  It
is live while a ``torch.profiler`` session records, and always once
``enable_default()`` armed it; nobody drains it, so its spans wait in a
ring of the last ``DEFAULT_RING`` (``Obs.tracer.spans()``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.obs.config import ObsConfig
from repro_torch.obs.metrics import Registry
from repro_torch.obs.sinks import ConsoleSink, JSONLSink, MemorySink
from repro_torch.obs.tracing import Tracer


DEFAULT_RING = 4096


class Obs:
    def __init__(self, enabled: bool = True,
                 registry: Optional[Registry] = None, sinks=(),
                 follows_profiler: bool = False):
        self.metrics = registry if registry is not None else Registry()
        # a facade that follows the profiler is never drained: its spans
        # wait in a ring
        self.tracer = Tracer(
            self.metrics, enabled=enabled, follows_profiler=follows_profiler,
            ring=DEFAULT_RING if follows_profiler else None)
        self.sinks = list(sinks)

    @property
    def enabled(self) -> bool:
        """Live: armed, or following a profiler that records."""
        return self.tracer.live

    @enabled.setter
    def enabled(self, on: bool) -> None:
        self.tracer.enabled = on

    # ------------------------------------------------------------------
    # tracing
    def span(self, name: str, **tags):
        return self.tracer.span(name, **tags)

    def device_span(self, name: str, device, **tags):
        return self.tracer.device_span(name, device, **tags)

    def trace(self, name: str):
        return self.tracer.trace(name)

    # ------------------------------------------------------------------
    # sinks
    def emit(self, record: Dict) -> None:
        for sink in self.sinks:
            sink.emit(record)

    def round_record(self, record: Dict) -> Dict:
        """Attach the drained span breakdown to ``record`` and emit it.

        ``phases`` maps each depth-1 span name to its summed seconds;
        ``round_s`` is the enclosing depth-0 ``round`` span's duration,
        so consumers can check that the phases cover the round.
        ``spans`` lists every drained span as ``[name, parent, t0_ns,
        t1_ns, tags]`` (``parent`` an index into the list, the times on
        the profiler's Unix-epoch clock); the record's ``round`` is the
        identifier they share."""
        phases: Dict[str, float] = {}
        round_s = None
        spans = self.tracer.drain()
        for s in spans:
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
        if spans:
            out["spans"] = [[s.name, s.parent, s.t0_ns, s.t1_ns, s.tags]
                            for s in spans]
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

# Process-wide facade for code without a trainer handle: live while a
# profiler records, armed for good by ``enable_default()``.
DEFAULT = Obs(enabled=False, follows_profiler=True)


def enable_default(sinks=()) -> Obs:
    """Arm the process-wide ``DEFAULT`` facade (idempotent)."""
    DEFAULT.enabled = True
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
