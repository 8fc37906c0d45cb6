"""repro_torch.obs — round-phase tracing, metrics registry, sinks.

The observability substrate for the FL engine (carried over from
``repro.obs``):

  * ``Obs`` / ``from_config`` — the facade trainers hold (span tracer +
    metrics registry + sink fan-out); ``DISABLED`` is the shared no-op
    used whenever ``FLConfig.obs.enabled`` is False; ``DEFAULT`` the
    facade of library code without a trainer handle, live while a
    ``torch.profiler`` session records.  Spans carry their ends on the
    profiler's clock and their parent (``tracing``).
  * ``Registry`` / ``Counter`` / ``Gauge`` / ``Histogram`` — host-side
    metrics with fixed-bucket percentiles; never a device sync.
  * ``MemorySink`` / ``JSONLSink`` / ``ConsoleSink`` — per-round record
    sinks; ``read_jsonl`` / ``format_summary`` for consumers.
  * ``profile_rounds`` — a ``torch.profiler`` trace of N rounds, with the
    device's busy share (the union of its intervals) and op count, split
    by phase.

Span names emitted by the trainers: ``round`` (whole round), and its
phases ``prep`` / ``core`` / ``schedule`` / ``upload`` / ``finalize``,
plus ``solve_many.<backend>`` inside scheduling and ``eval`` (tagged
with its ``cell`` in a multi-cell engine) inside ``finalize``.  The LM
train step (``fl.distributed.make_train_step``): ``lm.step`` over
``lm.trunk``, ``lm.head``, ``lm.backward`` (``lm.head_bwd`` then
``lm.trunk_bwd``) and ``lm.update``.
"""
from repro_torch.obs.config import ObsConfig  # noqa: F401
from repro_torch.obs.core import (DEFAULT, DEFAULT_RING,  # noqa: F401
                                  DISABLED, Obs, enable_default, from_config)
from repro_torch.obs.metrics import (COUNT_BUCKETS,  # noqa: F401
                                     TIME_BUCKETS, Counter, Gauge,
                                     Histogram, Registry)
from repro_torch.obs.profile import Profile, profile_rounds  # noqa: F401
from repro_torch.obs.sinks import (ConsoleSink, JSONLSink,  # noqa: F401
                                   MemorySink, dumps_record, format_summary,
                                   read_jsonl)
from repro_torch.obs.tracing import NULL_SPAN, SpanRecord, Tracer  # noqa: F401
