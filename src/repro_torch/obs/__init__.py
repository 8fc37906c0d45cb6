"""repro_torch.obs — round-phase tracing, metrics registry, sinks.

The observability substrate for the FL engine (carried over from
``repro.obs``; the ``jax.profiler`` capture has no counterpart here yet):

  * ``Obs`` / ``from_config`` — the facade trainers hold (span tracer +
    metrics registry + sink fan-out); ``DISABLED`` is the shared no-op
    used whenever ``FLConfig.obs.enabled`` is False.
  * ``Registry`` / ``Counter`` / ``Gauge`` / ``Histogram`` — host-side
    metrics with fixed-bucket percentiles; never a device sync.
  * ``MemorySink`` / ``JSONLSink`` / ``ConsoleSink`` — per-round record
    sinks; ``read_jsonl`` / ``format_summary`` for consumers.

Span names emitted by the trainer: ``round`` (whole round), and its
phases ``prep`` / ``core`` / ``schedule`` / ``upload`` / ``finalize``,
plus ``solve_many.<backend>`` inside scheduling.
"""
from repro_torch.obs.config import ObsConfig  # noqa: F401
from repro_torch.obs.core import (DEFAULT, DISABLED, Obs,  # noqa: F401
                                  enable_default, from_config)
from repro_torch.obs.metrics import (COUNT_BUCKETS,  # noqa: F401
                                     TIME_BUCKETS, Counter, Gauge,
                                     Histogram, Registry)
from repro_torch.obs.sinks import (ConsoleSink, JSONLSink,  # noqa: F401
                                   MemorySink, dumps_record, format_summary,
                                   read_jsonl)
from repro_torch.obs.tracing import NULL_SPAN, SpanRecord, Tracer  # noqa: F401
