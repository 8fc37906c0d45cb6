"""FDMA minimum-bandwidth allocation (paper Eq. 9).

A scheduled device must upload D_w bits within deadline d_cm at rate
    r = B log2(1 + S*H / (B*N0)),
so the minimal feasible bandwidth solves r(B) * d_cm = D_w.  Substituting
u = S*H/(N0*B) gives ln(1+u)/u = Gamma with
    Gamma = N0 * D_w * ln2 / (d_cm * S * H),
whose non-trivial root is u = -W_{-1}(-Gamma e^{-Gamma})/Gamma - 1 for
Gamma < 1; Gamma >= 1 means the required rate exceeds the channel's
capacity limit S*H/(N0 ln2) — infeasible even with infinite bandwidth
(the paper's "minus B*" case, excluded by the last constraint of P1).
"""
from __future__ import annotations

import numpy as np
from scipy.special import lambertw


def min_bandwidth(data_bits: float, deadline_s: float, tx_power_gain: np.ndarray,
                  noise_psd: float) -> np.ndarray:
    """Vectorized Eq. 9.

    tx_power_gain = S * H_v (received signal power, W).
    Returns B_v* in Hz; -1.0 marks infeasible devices."""
    sh = np.asarray(tx_power_gain, dtype=np.float64)
    gamma = noise_psd * data_bits * np.log(2.0) / (deadline_s * sh)
    feasible = gamma < 1.0
    g = np.where(feasible, gamma, 0.5)           # safe placeholder
    w = lambertw(-g * np.exp(-g), k=-1).real     # W_{-1} branch
    bstar = -data_bits * np.log(2.0) / (deadline_s * (w + g))
    return np.where(feasible, bstar, -1.0)


def min_bandwidth_bisect(data_bits: float, deadline_s: float, sh: float,
                         noise_psd: float, tol: float = 1e-9) -> float:
    """Reference root-finder for tests (no Lambert-W)."""
    cap = sh / (noise_psd * np.log(2.0))         # B -> inf rate limit
    need = data_bits / deadline_s
    if need >= cap:
        return -1.0

    def rate(b):
        return b * np.log2(1.0 + sh / (b * noise_psd))

    lo, hi = 1e-6, 1.0
    while rate(hi) < need:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if rate(mid) < need:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * hi:
            break
    return 0.5 * (lo + hi)


def deadline_met(bandwidth_hz, data_bits: float, deadline_s: float,
                 tx_power_gain, noise_psd: float,
                 slack: float = 0.0) -> np.ndarray:
    """Eq. 9 feasibility at a *fixed* allocation (vectorized).

    True where a device granted ``bandwidth_hz`` can push ``data_bits``
    within ``(1 + slack) * deadline_s`` at the given received power —
    the upload-time check of the fault layer, where the gain may have
    shadow-faded since B* was allocated.  Non-positive bandwidth (the
    infeasible marker) is never met.  A relative 1e-9 tolerance keeps
    Eq. 9's equality allocation (rate(B*) * d_cm == D_w up to Lambert-W
    rounding) on the feasible side."""
    b = np.asarray(bandwidth_hz, dtype=np.float64)
    ok = b > 0
    rate = uplink_rate(np.where(ok, b, 1.0), tx_power_gain, noise_psd)
    return ok & (rate * deadline_s * (1.0 + slack)
                 >= data_bits * (1.0 - 1e-9))


def uplink_rate(bandwidth_hz, tx_power_gain, noise_psd):
    """Shannon FDMA rate r = B log2(1 + S*H/(B*N0)) (vectorized)."""
    b = np.asarray(bandwidth_hz, dtype=np.float64)
    return b * np.log2(1.0 + np.asarray(tx_power_gain) / (b * noise_psd))
