"""Per-round wireless fault injection.

``FaultInjector.draw(j)`` realises one round's faults for every device
from a generator seeded by ``(trainer seed, fault seed, round index)``:
the draws do not consume the trainer's RNG stream and do not depend on
which devices end up available or scheduled, so histories are bitwise
reproducible and faults can be evaluated lazily per device.

Failure-cause precedence for a scheduled upload:
    dropout > deadline (compute straggler) > outage (channel) > corrupt
The first three are *arrival* failures (the upload never lands and its
bandwidth is reclaimable by the backfill pass); "corrupt" uploads do
arrive — the server-side sanitizer decides their fate.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

import torch

from repro_torch.core.bandwidth import deadline_met
from repro_torch.faults.config import FaultConfig
from repro_torch.wireless.channel import apply_shadow_db

# Arrival-failure causes + corruption, in precedence order.
FAILURE_CAUSES = ("dropout", "deadline", "outage", "corrupt")


@dataclasses.dataclass
class RoundFaults:
    """One round's fault realisation over all V devices."""
    dropout: np.ndarray        # [V] bool
    deadline_miss: np.ndarray  # [V] bool
    outage: np.ndarray         # [V] bool — blanket Bernoulli outage
    reshadow_db: np.ndarray    # [V] float — second shadow draw (dB)
    corrupt: np.ndarray        # [V] bool
    corrupt_mode: np.ndarray   # [V] int — index into cfg.corrupt_modes

    @classmethod
    def none(cls, num_devices: int) -> "RoundFaults":
        z = np.zeros(num_devices, dtype=bool)
        return cls(dropout=z, deadline_miss=z.copy(), outage=z.copy(),
                   reshadow_db=np.zeros(num_devices),
                   corrupt=z.copy(),
                   corrupt_mode=np.zeros(num_devices, dtype=np.int64))


class FaultInjector:
    def __init__(self, cfg: FaultConfig, num_devices: int, base_seed: int,
                 obs=None):
        self.cfg = cfg
        self.num_devices = num_devices
        self.base_seed = base_seed
        # optional repro_torch.obs facade: injected-fault counters (set by the
        # trainers; None or a disabled facade = no telemetry)
        self.obs = obs

    @property
    def enabled(self) -> bool:
        return self.cfg.injection_enabled

    def _count_injected(self, rf: "RoundFaults") -> None:
        """Mirror one realisation into the metrics registry (host-side
        numpy sums only — never on the obs-disabled path)."""
        m = self.obs.metrics
        m.counter("faults.rounds_drawn").inc()
        for name, arr in (("dropout", rf.dropout),
                          ("deadline", rf.deadline_miss),
                          ("outage", rf.outage), ("corrupt", rf.corrupt)):
            n = int(arr.sum())
            if n:
                m.counter(f"faults.injected.{name}").inc(n)

    def _raw_draw(self, round_idx: int):
        """One round's raw RNG arrays, in ``draw``'s exact consumption
        order (uniforms for dropout/deadline/outage, the reshadow
        normals, the corrupt uniforms and mode integers)."""
        cfg = self.cfg
        V = self.num_devices
        rng = np.random.default_rng(
            [0xFA017, self.base_seed, cfg.seed, round_idx])
        u_drop = rng.random(V)
        u_dead = rng.random(V)
        u_out = rng.random(V)
        reshadow = (rng.normal(0.0, cfg.reshadow_std_db, V)
                    if cfg.reshadow_std_db > 0 else np.zeros(V))
        u_cor = rng.random(V)
        mode = rng.integers(0, len(cfg.corrupt_modes), V)
        return u_drop, u_dead, u_out, reshadow, u_cor, mode

    # ------------------------------------------------------------------
    def draw(self, round_idx: int) -> RoundFaults:
        """Realise round ``round_idx``'s faults (all-clear when inert)."""
        if not self.enabled:
            return RoundFaults.none(self.num_devices)
        cfg = self.cfg
        u_drop, u_dead, u_out, reshadow, u_cor, mode = \
            self._raw_draw(round_idx)
        rf = RoundFaults(
            dropout=u_drop < cfg.dropout_prob,
            deadline_miss=u_dead < cfg.deadline_miss_prob,
            outage=u_out < cfg.outage_prob,
            reshadow_db=reshadow,
            corrupt=u_cor < cfg.corrupt_prob,
            corrupt_mode=mode,
        )
        if self.obs is not None and self.obs.enabled:
            self._count_injected(rf)
        return rf

    @staticmethod
    def draw_many(injectors: Sequence["FaultInjector"],
                  round_idx: int) -> List[RoundFaults]:
        """One round's faults for C injectors with O(1) vectorized
        threshold passes over stacked [C, V] draws.

        Each injector's raw uniforms/normals still come from its own
        ``(seed, round)``-keyed generator in ``draw``'s order, so every
        cell's realisation is bitwise-identical to a standalone
        ``draw`` call; only the post-draw comparisons are batched.  The
        all-inert case allocates one [C, V] zero block shared by every
        cell instead of C sets of per-cell arrays."""
        C = len(injectors)
        V = injectors[0].num_devices
        if not any(inj.enabled for inj in injectors):
            zb = np.zeros((C, V), dtype=bool)
            zf = np.zeros((C, V))
            zi = np.zeros((C, V), dtype=np.int64)
            return [RoundFaults(dropout=zb[c], deadline_miss=zb[c],
                                outage=zb[c], reshadow_db=zf[c],
                                corrupt=zb[c], corrupt_mode=zi[c])
                    for c in range(C)]
        raws = [inj._raw_draw(round_idx) if inj.enabled
                else (np.ones(V), np.ones(V), np.ones(V), np.zeros(V),
                      np.ones(V), np.zeros(V, dtype=np.int64))
                for inj in injectors]
        u = [np.stack(cols) for cols in zip(*raws)]       # 6 x [C, V]
        prob = np.array([[inj.cfg.dropout_prob, inj.cfg.deadline_miss_prob,
                          inj.cfg.outage_prob, inj.cfg.corrupt_prob]
                         for inj in injectors])           # [C, 4]
        drop = u[0] < prob[:, 0:1]
        dead = u[1] < prob[:, 1:2]
        out = u[2] < prob[:, 2:3]
        cor = u[4] < prob[:, 3:4]
        rfs = [RoundFaults(dropout=drop[c], deadline_miss=dead[c],
                           outage=out[c], reshadow_db=u[3][c],
                           corrupt=cor[c], corrupt_mode=u[5][c])
               for c in range(C)]
        for inj, rf in zip(injectors, rfs):
            if inj.enabled and inj.obs is not None and inj.obs.enabled:
                inj._count_injected(rf)
        return rfs

    # ------------------------------------------------------------------
    def upload_gains(self, gains: np.ndarray, rf: RoundFaults) -> np.ndarray:
        """Channel gains as seen at upload time (second shadow draw)."""
        if self.cfg.reshadow_std_db <= 0:
            return gains
        return apply_shadow_db(gains, rf.reshadow_db)

    def arrival_failures(self, rf: RoundFaults, scheduled: np.ndarray,
                         alloc_bw: np.ndarray, data_bits: float,
                         deadline_s: float, upload_rx_power: np.ndarray,
                         noise_psd: float) -> np.ndarray:
        """Per-device arrival-failure cause ("" = the upload lands).

        ``scheduled``/``alloc_bw``/``upload_rx_power`` are [V] global
        arrays; alloc_bw is the bandwidth granted at scheduling time
        (Eq. 9's B* under the scheduling-time gains).
        """
        cause = np.full(self.num_devices, "", dtype=object)
        sched = np.asarray(scheduled, dtype=bool)
        if not self.enabled or not sched.any():
            return cause
        cause[sched & rf.dropout] = "dropout"
        free = sched & (cause == "")
        cause[free & rf.deadline_miss] = "deadline"
        free = sched & (cause == "")
        out = free & rf.outage
        if self.cfg.reshadow_std_db > 0:
            met = deadline_met(alloc_bw, data_bits, deadline_s,
                               upload_rx_power, noise_psd,
                               slack=self.cfg.outage_slack)
            out |= free & ~met
        cause[out] = "outage"
        return cause

    # ------------------------------------------------------------------
    def corrupt_delta(self, delta, mode: str):
        """Damage one device's model delta (dict of tensors) in the given
        mode."""
        if mode == "nan":
            return {k: torch.full_like(x, float("nan"))
                    for k, x in delta.items()}
        if mode == "inf":
            return {k: torch.full_like(x, float("inf"))
                    for k, x in delta.items()}
        if mode == "explode":
            s = self.cfg.corrupt_scale
            return {k: x * torch.as_tensor(s, dtype=x.dtype,
                                           device=x.device)
                    for k, x in delta.items()}
        raise ValueError(f"unknown corrupt mode {mode!r}")

    def corrupt_mode_of(self, rf: RoundFaults, v: int) -> str:
        return self.cfg.corrupt_modes[
            int(rf.corrupt_mode[v]) % len(self.cfg.corrupt_modes)]
