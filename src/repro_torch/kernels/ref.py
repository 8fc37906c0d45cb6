"""Plain PyTorch versions of the port's kernels (the allclose targets).

They mirror ``repro/kernels/ref.py`` and are deliberately naive: the
swap matrix and the per-sample gradients are materialised in full.  The
CPU path of ``repro_torch.kernels.ops`` runs them; nothing on the CUDA
path does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def wemd_swap_ref(p_sum, p_dev, global_dist, class_weights, sizes):
    """Batched dense swap-candidate WEMD matrix (paper Eq. 8 applied to
    Pi \\ {i} u {j} for every pair).  p_sum [B,C], p_dev [B,V,C],
    global_dist/class_weights [B,C], sizes [B] -> [B,V,V]."""
    base = (p_sum[:, None, None, :] - p_dev[:, :, None, :]) \
        + p_dev[:, None, :, :]
    dist = base / sizes[:, None, None, None]
    return torch.sum(torch.abs(dist - global_dist[:, None, None, :])
                     * class_weights[:, None, None, :], dim=-1)


def wemd_add_ref(p_sum, p_dev, global_dist, class_weights, sizes):
    """Batched add-candidate WEMD row (Pi u {v} for every v).
    Same layouts as ``wemd_swap_ref``; returns [B, V]."""
    new = (p_sum[:, None, :] + p_dev) / (sizes[:, None, None] + 1.0)
    return torch.sum(torch.abs(new - global_dist[:, None, :])
                     * class_weights[:, None, :], dim=-1)


def persample_gradnorm_ref(features, logits, labels):
    """sigma-hat (Eq. 10) for a softmax-CE linear head, materialising the
    per-sample gradient tensor [..., B, d, C] (the thing the kernel
    avoids).  features [..., B, d], logits [..., B, C], labels [..., B]
    -> (sigma [...], gi_sq [..., B])."""
    h = features.to(torch.float32)
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    e = p - F.one_hot(labels.long(), logits.shape[-1]).to(torch.float32)
    g = h[..., :, :, None] * e[..., :, None, :]          # [..., B, d, C]
    gbar = g.mean(-3)
    dev = g - gbar[..., None, :, :]
    dev_sq = (dev * dev).sum((-2, -1))
    return torch.sqrt(dev_sq.mean(-1)), (g * g).sum((-2, -1))
