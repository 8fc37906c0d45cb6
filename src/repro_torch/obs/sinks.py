"""Pluggable round-record sinks + the human-readable summary.

A sink is anything with ``emit(record: dict)`` and ``close()``.  The
trainers emit one record per round (after the round's device work is
done — no extra host syncs on the hot path):

  * ``MemorySink``   — fixed-capacity ring buffer of the last N records
  * ``JSONLSink``    — one JSON object per line, flushed per emit
  * ``ConsoleSink``  — compact one-line digest per record

``format_summary(registry)`` renders the end-of-run table: per-span
p50/p95/mean/total from the ``span.*`` histograms plus every counter
and gauge (failure-cause totals, host syncs, compile counts, ...).
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Dict, List

import numpy as np

from repro_torch.obs.metrics import Registry


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def dumps_record(record: Dict) -> str:
    """One record as a compact JSON line (numpy scalars coerced)."""
    return json.dumps(record, default=_json_default,
                      separators=(",", ":"))


class MemorySink:
    """Ring buffer of the last ``capacity`` records."""

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self._buf = deque(maxlen=capacity)

    def emit(self, record: Dict) -> None:
        self._buf.append(record)

    def records(self) -> List[Dict]:
        return list(self._buf)

    def close(self) -> None:
        pass


class JSONLSink:
    """One JSON object per line; flushed after every emit so a crashed
    run keeps all completed rounds."""

    def __init__(self, path: str, mode: str = "w"):
        self.path = str(path)
        self._f = open(self.path, mode)

    def emit(self, record: Dict) -> None:
        self._f.write(dumps_record(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_jsonl(path: str) -> List[Dict]:
    """Load every record of a JSONL metrics file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class ConsoleSink:
    """Compact per-record console line (round digests, not raw JSON)."""

    def emit(self, record: Dict) -> None:
        kind = record.get("kind", "record")
        j = record.get("round", "?")
        bits = [f"[obs] {kind} {j}"]
        for k in ("num_scheduled", "num_uploaded", "num_failed",
                  "host_syncs", "cells"):
            if k in record:
                bits.append(f"{k}={record[k]}")
        if "round_s" in record:
            bits.append(f"round={record['round_s'] * 1e3:.1f}ms")
        phases = record.get("phases")
        if phases:
            bits.append(" ".join(f"{k}={v * 1e3:.1f}ms"
                                 for k, v in phases.items()))
        print(" ".join(bits))

    def close(self) -> None:
        pass


def _fmt_s(v: float) -> str:
    if v != v:          # nan
        return "    -"
    if v >= 1.0:
        return f"{v:7.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:6.1f}ms"
    return f"{v * 1e6:6.1f}us"


def format_summary(registry: Registry) -> str:
    """End-of-run console summary: span percentiles + counters/gauges."""
    lines = []
    hists = {k[len("span."):]: h for k, h in registry.histograms.items()
             if k.startswith("span.") and h.count}
    if hists:
        lines.append("-- span timings --")
        lines.append(f"{'span':<24}{'count':>7}{'p50':>10}{'p95':>10}"
                     f"{'mean':>10}{'total':>10}")
        for name in sorted(hists):
            h = hists[name]
            lines.append(f"{name:<24}{h.count:>7}"
                         f"{_fmt_s(h.percentile(0.5)):>10}"
                         f"{_fmt_s(h.percentile(0.95)):>10}"
                         f"{_fmt_s(h.mean):>10}{_fmt_s(h.sum):>10}")
    other = {k: h for k, h in registry.histograms.items()
             if not k.startswith("span.") and h.count}
    if other:
        lines.append("-- histograms --")
        for name in sorted(other):
            h = other[name]
            lines.append(f"{name:<32} count={h.count} mean={h.mean:.3g} "
                         f"p50={h.percentile(0.5):.3g} "
                         f"p95={h.percentile(0.95):.3g}")
    counters = registry.counters
    if counters:
        lines.append("-- counters --")
        for name in sorted(counters):
            v = counters[name].value
            lines.append(f"{name:<32} "
                         f"{int(v) if v == int(v) else round(v, 6)}")
    gauges = {k: g for k, g in registry.gauges.items()
              if not math.isnan(g.value)}
    if gauges:
        lines.append("-- gauges --")
        for name in sorted(gauges):
            lines.append(f"{name:<32} {gauges[name].value:.6g}")
    return "\n".join(lines)
