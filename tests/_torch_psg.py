"""Shared inputs and truth for the Eq. 10 kernel's accuracy tests (no JAX
import, so the card-only test file can use them too)."""
import numpy as np
import torch


def psg_aligned(V, B, d, C, seed, spread=0.003, scale=1e4):
    """Per-sample gradients sharing a large common part (every h_i near
    one direction, every softmax near one class, one label): mean
    ||g_i||^2 / sigma^2 is about 1 / spread^2, where a one-pass f32 sum
    of sigma^2 loses three digits.  numpy h [V, B, d] and logits
    [V, B, C] in f32, labels [V, B] int64."""
    rng = np.random.default_rng(seed)
    h = scale * (rng.normal(size=(V, 1, d))
                 + spread * rng.normal(size=(V, B, d)))
    logits = rng.normal(size=(V, B, C))
    logits[..., 0] += 30.0
    return (h.astype(np.float32), logits.astype(np.float32),
            np.ones((V, B), np.int64))


def sigma_f64(h, logits, labels):
    """Eq. 10 in f64 from the materialised per-sample gradients: h
    [..., B, d], logits [..., B, C], labels [..., B] -> [...]."""
    e = torch.softmax(logits.double(), -1) - torch.nn.functional.one_hot(
        labels, logits.shape[-1]).double()
    g = h.double()[..., :, :, None] * e[..., :, None, :]
    return torch.sqrt(((g - g.mean(-3, keepdim=True)) ** 2).sum((-2, -1))
                      .mean(-1))


def psg_resnet_head(V, B, d, C, seed):
    """Inputs shaped like ResNet18-GN's head on the FL round: pooled
    post-ReLU features (non-negative, about 1 each), small logits (a
    softmax near uniform over C classes), random labels.  numpy h [V, B,
    d] and logits [V, B, C] in f32, labels [V, B] int64."""
    rng = np.random.default_rng(seed)
    return (np.abs(rng.normal(size=(V, B, d))).astype(np.float32),
            (0.3 * rng.normal(size=(V, B, C))).astype(np.float32),
            rng.integers(0, C, (V, B)))


def round_tolerance(h, truth):
    """What the FL round holds the kernel's sigma [...] to against Eq. 10
    in f64 (``truth``), as ``chip_smoke.sigma_tolerance``: 2e-6 of it
    plus 1e-6 of the device's rms ||h_i|| (h [..., B, d])."""
    return 2e-6 * truth + 1e-6 * torch.sqrt(
        (h.double() ** 2).sum(-1).mean(-1))
