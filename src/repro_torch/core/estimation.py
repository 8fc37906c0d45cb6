"""On-line parameter estimation for P1 (paper Section V-C, Eq. 10-12).

sigma (stochastic-gradient std): estimated per device from the first batch
as the rms deviation of per-sample gradients from the batch gradient
(Eq. 10), then aggregated as sqrt(sum_v alpha_v sigma_v^2) (Eq. 11).

G (class-gradient norm scale): estimated from model deltas after local
update, G = max_v ||grad_v - grad_global|| / ||p_v - p||_1 (Eq. 12); when
every device holds a single class, per-class G_c is available (the
FedCGD-FSCD-Gc variant).

Parameter trees are dicts (possibly nested) of tensors.  For softmax-CE
classifiers the last-layer per-sample gradient norm admits the
decomposition ||g_i||^2 = ||p_i - y_i||^2 * ||h_i||^2, which
``repro_torch.kernels`` fuses into one CUDA kernel
(``sigma_hat_lastlayer(..., use_kernel=True)``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf at once, in f32: each leaf's f32 copy is
    squared in place, so one f32 copy of a leaf is live at a time."""
    return torch.sqrt(sum(torch.sum(x.to(torch.float32, copy=True)
                                    .square_())
                          for x in tree_leaves(tree)))


def tree_row_norms(stacked) -> torch.Tensor:
    """[N] L2 norms of the rows of a tree whose leaves share a leading
    [N] axis (the per-device ``tree_norm``)."""
    return torch.sqrt(sum(torch.square(x.to(torch.float32))
                          .reshape(x.shape[0], -1).sum(dim=1)
                          for x in tree_leaves(stacked)))


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_weighted_sum(trees, weights):
    out = tree_map(lambda x: x * weights[0], trees[0])
    for t, w in zip(trees[1:], weights[1:]):
        out = tree_map(lambda x, y: x + y * w, out, t)
    return out


# ---------------------------------------------------------------------------
# Eq. 10-11: sigma estimation


def sigma_hat_exact(loss_per_sample: Callable, params, batch) -> torch.Tensor:
    """Eq. 10 by brute force: vmapped per-sample grads.

    loss_per_sample(params, example) -> scalar; batch is a tree whose
    leaves have a leading batch dim."""
    grads = torch.func.vmap(torch.func.grad(loss_per_sample),
                            in_dims=(None, 0))(params, batch)
    dev = tree_map(lambda g: g - g.mean(0)[None], grads)
    sq = sum(torch.square(x.to(torch.float32)).reshape(x.shape[0], -1)
             .sum(dim=1) for x in tree_leaves(dev))
    return torch.sqrt(sq.mean())


def sigma_hat_lastlayer(features: torch.Tensor, logits: torch.Tensor,
                        labels: torch.Tensor,
                        use_kernel: bool = False) -> torch.Tensor:
    """Eq. 10 restricted to the classifier head W in R^{d x C}:
    per-sample grad g_i = h_i (p_i - y_i)^T, so
    ||g_i - gbar||^2 is computed without materializing [B, d, C].

    features [..., B, d], logits [..., B, C], labels [..., B] -> sigma
    [...]: a leading device axis gives every device's sigma in one call.
    ``use_kernel`` computes it with the fused kernel (the CUDA kernel on
    a CUDA tensor, its plain version on a CPU tensor)."""
    if use_kernel:
        from repro_torch.kernels import ops
        return ops.persample_gradnorm_sigma(features, logits, labels)
    h = features.to(torch.float32)                         # [..., B, d]
    p = torch.softmax(logits.to(torch.float32), dim=-1)    # [..., B, C]
    e = p - F.one_hot(labels.long(), logits.shape[-1]).to(torch.float32)
    gbar = (h.transpose(-1, -2) @ e) / h.shape[-2]         # [..., d, C]
    # ||g_i||^2 = ||h_i||^2 ||e_i||^2 ; <g_i, gbar> = h_i^T gbar e_i
    gi_sq = (h * h).sum(-1) * (e * e).sum(-1)              # [..., B]
    cross = ((h @ gbar) * e).sum(-1)
    gbar_sq = (gbar * gbar).sum((-2, -1))
    dev_sq = gi_sq - 2.0 * cross + gbar_sq[..., None]
    return torch.sqrt(torch.clamp(dev_sq.mean(-1), min=0.0))


def sigma_hat_global(sigma_v: np.ndarray, alpha: np.ndarray) -> float:
    """Eq. 11: sqrt(sum_v alpha_v sigma_v^2)."""
    return float(np.sqrt(np.sum(np.asarray(alpha) *
                                np.square(np.asarray(sigma_v)))))


# ---------------------------------------------------------------------------
# Eq. 12: G estimation from model deltas


def device_grad_estimate(w_new, w_old, tau: int, eta: float):
    """nabla f_v ≈ (w_old - w_new)/(tau*eta)  (descent direction)."""
    return tree_map(lambda a, b: (b - a) / (tau * eta), w_new, w_old)


def _centered_grad_norms(grads_stacked, alphas: torch.Tensor):
    """[U] norms ||grad_v - sum_u alpha_u grad_u|| from a stacked [U, ...]
    gradient tree — the Eq. 12 numerators."""
    def center(g):
        a = alphas.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
        return g - (g * a).sum(0)[None]
    return tree_row_norms(tree_map(center, grads_stacked))


def _grad_deviation_norms(device_grads, alphas) -> np.ndarray:
    """Accepts a list of per-device trees *or* one tree with a leading
    [U] device axis; returns the [U] deviation norms with a single host
    pull."""
    if isinstance(device_grads, (list, tuple)):
        device_grads = tree_map(lambda *xs: torch.stack(xs),
                                *device_grads)
    leaf = tree_leaves(device_grads)[0]
    alphas = torch.as_tensor(np.asarray(alphas, dtype=np.float64),
                             dtype=torch.float32, device=leaf.device)
    return _centered_grad_norms(device_grads, alphas).cpu().numpy()


def g_hat(device_grads, alphas, p_dev: np.ndarray,
          global_dist: np.ndarray,
          norms: Optional[np.ndarray] = None) -> float:
    """Eq. 12: max_v ||grad_v - grad_global|| / ||p_v - p||_1.

    ``device_grads`` is a list of per-device trees or a stacked tree with
    a leading [U] device axis.  When the [U] deviation norms were already
    computed on the device (the fused finalize core), pass them as
    ``norms`` — no device round-trip is made and ``device_grads``/
    ``alphas`` may be None."""
    if norms is None:
        norms = _grad_deviation_norms(device_grads, alphas)
    l1 = np.abs(np.asarray(p_dev) - np.asarray(global_dist)).sum(axis=1)
    valid = l1 >= 1e-9
    if not valid.any():
        return 0.0
    return float(np.max(norms[valid] / l1[valid]))


def g_hat_per_class(device_grads, alphas, device_class: np.ndarray,
                    p_dev: np.ndarray, global_dist: np.ndarray,
                    num_classes: int,
                    norms: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-class G_c when each device holds a single class (the paper's
    FedCGD-FSCD-Gc variant): G_c = max_{v in Pi_c} ||grad_v - grad|| /
    ||p_v - p||_1.  ``norms`` as in ``g_hat``."""
    if norms is None:
        norms = _grad_deviation_norms(device_grads, alphas)
    l1 = np.abs(np.asarray(p_dev) - np.asarray(global_dist)).sum(axis=1)
    G = np.zeros(num_classes)
    for v in range(len(norms)):
        if l1[v] < 1e-9:
            continue
        c = int(device_class[v])
        G[c] = max(G[c], float(norms[v]) / l1[v])
    # classes never seen this round fall back to the max (conservative)
    fallback = G.max() if G.max() > 0 else 1.0
    return np.where(G > 0, G, fallback)
