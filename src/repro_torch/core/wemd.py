"""Weighted Earth-Mover Distance (paper Eq. 8).

For a classification problem, device-level collective gradient divergence
is bounded by

    Delta <= sum_c | sum_{v in Pi} p_{v,c} / |Pi|  -  p_c | * G_c

— the WEMD between the *group* label distribution of the scheduled set and
the global label distribution, weighted by per-class gradient norms G_c.

All functions are numpy (host-side scheduling math, exactly like the
paper's simulation); the estimation of G_c / sigma from gradients is PyTorch
and lives in core/estimation.py.
"""
from __future__ import annotations

import numpy as np


def normalize_rows(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.float64)
    s = counts.sum(axis=-1, keepdims=True)
    return counts / np.maximum(s, 1e-12)


def wemd(group_dist: np.ndarray, global_dist: np.ndarray,
         class_weights: np.ndarray) -> float:
    """WEMD between a group distribution and the global distribution."""
    return float(np.abs(group_dist - global_dist) @ class_weights)


def group_distribution(p_dev: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """p_dev [V,C] per-device label distributions; mask [V] bool/0-1.
    Equal aggregation weights (paper Sec. V-A assumes equal |D_v|)."""
    mask = np.asarray(mask, dtype=np.float64)
    s = mask.sum()
    if s == 0:
        return np.zeros(p_dev.shape[1])
    return mask @ p_dev / s


def wemd_of_set(p_dev: np.ndarray, mask: np.ndarray, global_dist: np.ndarray,
                class_weights: np.ndarray) -> float:
    """W(Pi) in Algorithm 1/2. Empty set convention: W = sum_c p_c G_c
    (max distance)."""
    mask = np.asarray(mask, dtype=np.float64)
    if mask.sum() == 0:
        return float(global_dist @ class_weights)
    return wemd(group_distribution(p_dev, mask), global_dist, class_weights)


def class_sum(x: np.ndarray, class_weights: np.ndarray) -> np.ndarray:
    """sum_c x[..., c] * w_c, accumulated left to right over classes.

    The schedulers rank candidates by these sums, and many candidates
    tie exactly (devices with equal label histograms under equal class
    weights).  ``x @ w`` goes through BLAS, whose result for a row
    depends on the row's position in the matrix, so equal rows can come
    out an ulp apart and the tie is broken by that noise.  A fixed order
    gives equal rows equal values on every device — the torch engine
    (``core/scheduling_torch.py``) sums in the same order — so ties fall
    to the lowest device index everywhere."""
    acc = x[..., 0] * class_weights[0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * class_weights[c]
    return acc


def wemd_add_candidates(p_sum: np.ndarray, size: int, p_dev: np.ndarray,
                        global_dist: np.ndarray,
                        class_weights: np.ndarray) -> np.ndarray:
    """Vectorized W(Pi ∪ {v}) for all v given the current group sum.

    p_sum [C] = sum of distributions of the current set of ``size``
    devices.  Returns [V] WEMD values.  O(V*C)."""
    new = (p_sum[None, :] + p_dev) / (size + 1)
    return class_sum(np.abs(new - global_dist[None, :]), class_weights)


def wemd_swap_candidates(p_sum: np.ndarray, size: int, p_dev: np.ndarray,
                         in_idx: np.ndarray, out_idx: np.ndarray,
                         global_dist: np.ndarray,
                         class_weights: np.ndarray) -> np.ndarray:
    """Vectorized W(Pi \\ {i} ∪ {j}) over all (i in set, j out of set).

    Returns [len(in_idx), len(out_idx)].  O(|in|*|out|*C) — the FSCD
    inner loop."""
    base = p_sum[None, None, :] - p_dev[in_idx][:, None, :] \
        + p_dev[out_idx][None, :, :]
    dist = base / size
    return class_sum(np.abs(dist - global_dist[None, None, :]),
                     class_weights)


def sampling_variance(sigma: float, num_scheduled: int, batch_size: int) -> float:
    """sigma / sqrt(|Pi| * b) — Lemma 2's sample-level CGD bound."""
    if num_scheduled <= 0:
        return np.inf
    return sigma / np.sqrt(num_scheduled * batch_size)


def p1_objective(mask: np.ndarray, p_dev: np.ndarray, global_dist: np.ndarray,
                 class_weights: np.ndarray, sigma: float,
                 batch_size: int) -> float:
    """The P1 objective: sampling variance + WEMD."""
    s = int(np.asarray(mask).sum())
    return sampling_variance(sigma, s, batch_size) + wemd_of_set(
        p_dev, mask, global_dist, class_weights)
