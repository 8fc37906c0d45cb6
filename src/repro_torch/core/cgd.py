"""Collective-gradient-divergence instrumentation (paper Section IV).

These functions *measure* the quantities the theory bounds, so the
convergence story is testable:

  device_level_cgd   Delta^{(j)} = || sum alpha_v grad_v - grad_F ||  (Eq. 5)
  sample_level_bound sigma / sqrt(|Pi| b)                             (Lemma 2)
  local_iter_bias    0.5 tau (tau-1) eta beta g                       (Lemma 3)
  fc_difference      U_j = || w^{(j)} - v^{(j)} ||                    (Sec. IV)

``repro_torch.fl.virtual`` computes the virtual centralized model
v^{(j)} these feed.  Gradient and parameter trees are dicts of tensors;
norms come back as 0-d f32 tensors on the trees' device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.estimation import tree_norm, tree_sub, tree_weighted_sum


def device_level_cgd(device_grads, alphas, global_grad) -> torch.Tensor:
    """Eq. 5 — the *collective* divergence of the scheduled group.

    device_grads: list of grad trees for v in Pi; alphas: their
    aggregation weights; global_grad: grad of the global objective."""
    agg = tree_weighted_sum(device_grads, [float(a) for a in
                                           np.asarray(alphas)])
    return tree_norm(tree_sub(agg, global_grad))


def individual_divergences(device_grads, global_grad) -> np.ndarray:
    """delta_v = ||grad_v - grad_F|| for each device (Remark 1: summing
    these does NOT give the collective divergence)."""
    return np.array([float(tree_norm(tree_sub(g, global_grad)))
                     for g in device_grads])


def sample_level_bound(sigma: float, num_scheduled: int,
                       batch_size: int) -> float:
    """Lemma 2: sigma / sqrt(|Pi| b) (inf with nobody scheduled)."""
    if num_scheduled <= 0:
        return float("inf")
    return sigma / np.sqrt(num_scheduled * batch_size)


def local_iter_bias_bound(tau: int, eta: float, beta: float,
                          g: float) -> float:
    """Lemma 3: 0.5 * tau(tau-1) * eta * beta * g."""
    return 0.5 * tau * (tau - 1) * eta * beta * g


def fc_difference(w_agg, w_virtual) -> torch.Tensor:
    """U_j = ||w^{(j)} - v^{(j)}||."""
    return tree_norm(tree_sub(w_agg, w_virtual))


def theorem1_bound(delta: float, sigma: float, num_scheduled: int,
                   batch_size: int, tau: int, eta: float, beta: float,
                   g: float) -> float:
    """Theorem 1's bound on E[U_j]."""
    return (local_iter_bias_bound(tau, eta, beta, g)
            + eta * tau * (sample_level_bound(sigma, num_scheduled,
                                              batch_size) + delta))
