"""Shared neural-net primitives (only what the paper CNN needs so far)."""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits, targets, mask=None, label_smoothing=0.0):
    """logits [..., C]; targets int [...]. Returns the mean over mask."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    onehot = (torch.arange(logits.shape[-1], device=logits.device)
              == targets[..., None])
    true_logit = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    loss = logz - true_logit
    if label_smoothing:
        loss = (1 - label_smoothing) * loss + label_smoothing * (
            logz - logits.mean(dim=-1))
    if mask is None:
        return loss.mean()
    mask = mask.to(torch.float32)
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
