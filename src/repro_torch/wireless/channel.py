"""3GPP TR 38.901 UMi-Street-Canyon uplink channel (paper Section VI-A,
Table I).

Path loss (f in GHz, d3d in m):
    PL_LOS  = 32.4 + 21.0  log10(d3d) + 20 log10(f)
    PL_NLOS = 32.4 + 31.9  log10(d3d) + 20 log10(f)
LOS probability:
    Pr_LOS = 18/d2d + exp(-d2d/36) (1 - 18/d2d)     (d2d > 18 m, else 1)
Shadow fading: lognormal, std 4 dB (LOS) / 8.2 dB (NLOS).
Fast fading is not modeled (paper: average rate over the upload deadline).

Default parameters are the paper's Table I.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    cell_radius_m: float = 250.0
    carrier_ghz: float = 3.5
    total_bandwidth_hz: float = 20e6
    tx_power_dbm: float = 23.0
    device_height_m: float = 1.5
    bs_height_m: float = 10.0
    noise_psd_dbm_hz: float = -174.0
    noise_figure_db: float = 6.0
    shadow_std_los_db: float = 4.0
    shadow_std_nlos_db: float = 8.2

    @property
    def tx_power_w(self) -> float:
        return 10 ** (self.tx_power_dbm / 10.0) * 1e-3

    @property
    def noise_psd_w(self) -> float:
        # receiver noise figure folds into the effective noise density
        return 10 ** ((self.noise_psd_dbm_hz + self.noise_figure_db) / 10.0) \
            * 1e-3


def los_probability(d2d: np.ndarray) -> np.ndarray:
    d2d = np.maximum(np.asarray(d2d, dtype=np.float64), 1e-3)
    p = 18.0 / d2d + np.exp(-d2d / 36.0) * (1.0 - 18.0 / d2d)
    return np.where(d2d <= 18.0, 1.0, np.minimum(p, 1.0))


def path_loss_db(d3d: np.ndarray, f_ghz: float, los: np.ndarray) -> np.ndarray:
    d3d = np.maximum(np.asarray(d3d, dtype=np.float64), 1.0)
    pl_los = 32.4 + 21.0 * np.log10(d3d) + 20.0 * np.log10(f_ghz)
    pl_nlos = 32.4 + 31.9 * np.log10(d3d) + 20.0 * np.log10(f_ghz)
    return np.where(los, pl_los, pl_nlos)


@dataclasses.dataclass
class CellState:
    """Positions + per-round channel realisation for V devices."""
    params: ChannelParams
    positions: np.ndarray        # [V, 2]
    d2d: np.ndarray              # [V]
    d3d: np.ndarray              # [V]

    def invariants(self):
        """Round-invariant channel quantities (cached): the per-device
        LOS probability and both path-loss branches.  Positions are
        fixed for a cell's lifetime, so only the LOS coin flip and the
        shadow draw vary per round."""
        inv = getattr(self, "_invariants", None)
        if inv is None:
            p = self.params
            inv = (los_probability(self.d2d),
                   path_loss_db(self.d3d, p.carrier_ghz,
                                np.ones(len(self.d3d), bool)),
                   path_loss_db(self.d3d, p.carrier_ghz,
                                np.zeros(len(self.d3d), bool)))
            self._invariants = inv
        return inv

    def draw_shadowed_loss_db(self, rng: np.random.Generator) -> np.ndarray:
        """One round's raw RNG pass: LOS coin flip + shadow draw, folded
        with the cached path loss into PL + X_shadow (dB).  Kept separate
        from the dB->linear conversion so a multi-cell driver can batch
        that last pass over a stacked [C, V] array."""
        p_los, pl_los, pl_nlos = self.invariants()
        p = self.params
        los = rng.random(len(self.d2d)) < p_los
        pl = np.where(los, pl_los, pl_nlos)
        shadow_std = np.where(los, p.shadow_std_los_db, p.shadow_std_nlos_db)
        shadow = rng.normal(0.0, shadow_std)
        return pl + shadow

    def draw_gains(self, rng: np.random.Generator) -> np.ndarray:
        """Average channel gain H_v for one round (linear, power)."""
        return 10 ** (-self.draw_shadowed_loss_db(rng) / 10.0)

    def received_power(self, gains: np.ndarray) -> np.ndarray:
        """S * H_v in W — feeds core.bandwidth.min_bandwidth."""
        return self.params.tx_power_w * gains


def draw_gains_batch(cells: Sequence[CellState],
                     rngs: Sequence[np.random.Generator]) -> np.ndarray:
    """Channel gains for C cells in one vectorized pass: [C, V].

    Each cell's raw draws (LOS coin flip, shadow fade) still come from
    its own generator in the exact order ``draw_gains`` consumes them —
    a cell's stream is bitwise-identical to a standalone draw — but the
    dB->linear conversion runs once over the stacked [C, V] array
    instead of C times over [V] slices (elementwise, so the values are
    unchanged)."""
    loss_db = np.stack([cell.draw_shadowed_loss_db(rng)
                        for cell, rng in zip(cells, rngs)])
    return 10 ** (-loss_db / 10.0)


def received_power_batch(cells: Sequence[CellState],
                         gains: np.ndarray) -> np.ndarray:
    """S * H for a [C, V] gain stack (per-cell tx power broadcast)."""
    tx = np.array([cell.params.tx_power_w for cell in cells])
    return tx[:, None] * np.asarray(gains)


def apply_shadow_db(gains: np.ndarray, shadow_db: np.ndarray) -> np.ndarray:
    """Fold an extra shadow-fading realisation (dB, positive = deeper
    fade) into linear power gains.

    The scheduler measures H_v once per round; a second draw at upload
    time models the shadowing decorrelating between measurement and
    transmission — the fault layer's upload-outage channel."""
    return np.asarray(gains, dtype=np.float64) \
        * 10.0 ** (-np.asarray(shadow_db, dtype=np.float64) / 10.0)


def make_cell(num_devices: int, rng: np.random.Generator,
              params: ChannelParams = ChannelParams()) -> CellState:
    """Devices uniform in the disc of the cell radius."""
    r = params.cell_radius_m * np.sqrt(rng.random(num_devices))
    theta = rng.random(num_devices) * 2 * np.pi
    pos = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    d2d = np.linalg.norm(pos, axis=1)
    dh = params.bs_height_m - params.device_height_m
    d3d = np.sqrt(d2d ** 2 + dh ** 2)
    return CellState(params=params, positions=pos, d2d=d2d, d3d=d3d)
