"""Observability knobs (``FLConfig.obs``).

Inert by default: with ``enabled=False`` the trainers hold the shared
``repro_torch.obs.DISABLED`` facade, every span is the no-op singleton, no
metric is written and no sink exists — a fault-free round is
bitwise-identical to a trainer built before the observability layer
existed and pays no measurable per-round cost.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    # Master switch.  False (default) = the no-op ``DISABLED`` facade.
    enabled: bool = False
    # Stream one JSON record per round (phase timings, telemetry) to
    # this path via the JSONL sink.  None = no file sink.
    jsonl_path: Optional[str] = None
    # Keep the last N round records in an in-memory ring buffer
    # (``Obs.records()``).  0 = no memory sink.
    ring_size: int = 1024
    # Print a one-line console digest of every round record.
    console: bool = False

    def __post_init__(self):
        if self.ring_size < 0:
            raise ValueError(f"ring_size must be >= 0, got {self.ring_size}")
        if self.jsonl_path is not None and not str(self.jsonl_path):
            raise ValueError("jsonl_path must be a non-empty path or None")
