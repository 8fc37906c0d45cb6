"""Fault-model knobs for the resilient round loop.

The paper's P1 schedules devices assuming every scheduled upload lands
within the deadline d_cm, but its own channel model (TR 38.901 shadow
fading, Eq. 9 infeasibility) implies real rounds lose uploads.
``FaultConfig`` describes, per round, which wireless/device failures are
injected and which server-side defenses are armed.  All draws are made
from a per-round seeded generator (seeded by ``(trainer seed, fault
seed, round index)``), so runs are bitwise reproducible and independent
of scheduling decisions.

With every probability at zero (the default) the fault layer is inert:
no random draws are made and ``FederatedTrainer`` reproduces the
fault-free round loop bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

CORRUPT_MODES = ("nan", "inf", "explode")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    # --- injection knobs (client / channel side) -----------------------
    # Bernoulli upload outage per scheduled device (blanket model).
    outage_prob: float = 0.0
    # Std (dB) of a *second* shadow-fading draw at upload time; a
    # degraded gain that pushes the achievable rate at the allocated
    # bandwidth below Eq. 9's requirement is a deadline miss -> outage.
    reshadow_std_db: float = 0.0
    # Fractional deadline slack tolerated before a re-shadowed upload
    # counts as an outage (0 = the strict Eq. 9 equality allocation).
    outage_slack: float = 0.0
    # Mid-round device dropout: the device computes and is scheduled,
    # then vanishes before upload (battery, mobility, churn).  Dropped
    # devices are also excluded from backfill.
    dropout_prob: float = 0.0
    # Compute-straggler deadline miss: the local update overruns its
    # compute budget and the upload never starts.
    deadline_miss_prob: float = 0.0
    # Corrupted delta: the upload arrives (consuming bandwidth) but its
    # payload is damaged — NaN/Inf leaves or a norm-exploded delta.
    corrupt_prob: float = 0.0
    corrupt_modes: Tuple[str, ...] = CORRUPT_MODES
    corrupt_scale: float = 1e8          # multiplier for "explode" mode
    # Extra seed folded into the per-round fault stream (lets two runs
    # share a trainer seed but draw different fault realisations).
    seed: int = 0

    # --- server-side defenses ------------------------------------------
    # Per-device delta L2-norm clip applied before Eq. 2 (0 = off).
    # The NaN/Inf guard is always on: non-finite deltas never aggregate.
    clip_delta_norm: float = 0.0
    # One-shot backfill: after upload failures, re-solve P1 over the
    # surviving feasible devices with the residual bandwidth budget.
    backfill: bool = True
    # On zero-upload rounds, sigma-hat / G-hat decay toward their priors
    # with this factor instead of freezing stale estimates.
    estimate_decay: float = 0.5

    def __post_init__(self):
        for name in ("outage_prob", "dropout_prob", "deadline_miss_prob",
                     "corrupt_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.reshadow_std_db < 0:
            raise ValueError("reshadow_std_db must be >= 0")
        if not self.corrupt_modes:
            raise ValueError("corrupt_modes must be non-empty")
        unknown = set(self.corrupt_modes) - set(CORRUPT_MODES)
        if unknown:
            raise ValueError(f"unknown corrupt modes: {sorted(unknown)}")
        if not 0.0 <= self.estimate_decay <= 1.0:
            raise ValueError("estimate_decay must be in [0, 1]")

    @property
    def injection_enabled(self) -> bool:
        """True when any fault can actually fire this run."""
        return (self.outage_prob > 0 or self.reshadow_std_db > 0
                or self.dropout_prob > 0 or self.deadline_miss_prob > 0
                or self.corrupt_prob > 0)
