"""The paper's CIFAR-10 CNN (Section VI-A), functional PyTorch.

paper_cnn: 2x[conv3x3-32]+pool+drop(0.2), 2x[conv3x3-64]+pool+drop(0.3),
FC-120-ReLU, FC-num_classes.  Images come in as NHWC [B, H, W, C] (the
layout of ``repro``'s datasets and models) and are viewed as NCHW for
the convolutions; conv weights are OIHW.  The flatten before ``fc1``
runs in (c, h, w) order, so ``fc1``'s rows are in that order (the JAX
model flattens NHWC, (h, w, c); ``repro_torch.convert`` permutes).

Dropout takes boolean keep masks drawn by the caller (one per dropout
layer, shapes from ``dropout_shapes``): ``torch.func.vmap`` cannot draw
per-device randomness from an explicit generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig

DROPOUT_RATES = (0.2, 0.3)


def channel_widths(cfg: CNNConfig):
    # width may be fractional (micro models): channel counts round to >= 1
    return (max(1, int(round(32 * cfg.width))),
            max(1, int(round(64 * cfg.width))))


def init_paper_cnn(generator: torch.Generator, cfg: CNNConfig):
    """He-normal init on the CPU generator's stream (parameters are
    moved to their device by the caller)."""
    if cfg.kind != "paper_cnn":
        raise NotImplementedError(f"{cfg.kind} is not ported yet")
    c32, c64 = channel_widths(cfg)
    flat = (cfg.image_size // 4) ** 2 * c64

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    def conv(cin, cout):
        return normal((cout, cin, 3, 3), math.sqrt(2 / (9 * cin)))

    return {
        "c1": conv(cfg.channels, c32),
        "c2": conv(c32, c32),
        "c3": conv(c32, c64),
        "c4": conv(c64, c64),
        "fc1": normal((flat, 120), math.sqrt(2 / flat)),
        "b1": torch.zeros(120),
        "fc2": normal((120, cfg.num_classes), 0.1),
        "b2": torch.zeros(cfg.num_classes),
    }


def dropout_shapes(cfg: CNNConfig, batch_size: int):
    """Shapes of the keep masks ``paper_cnn_forward`` takes (empty when
    the config has no dropout)."""
    if not cfg.dropout:
        return ()
    c32, c64 = channel_widths(cfg)
    s = cfg.image_size
    return ((batch_size, c32, s // 2, s // 2),
            (batch_size, c64, s // 4, s // 4))


def _conv(x, w):
    return F.conv2d(x, w, padding=1)          # 3x3, stride 1: SAME


def _dropout(x, rate, keep):
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


def paper_cnn_features(params, cfg: CNNConfig, images, dropout=None):
    """images [B,H,W,C] -> penultimate features [B,120] (after ReLU)."""
    keep1, keep2 = dropout if dropout else (None, None)
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_conv(x, params["c1"]))
    x = F.relu(_conv(x, params["c2"]))
    x = _dropout(F.max_pool2d(x, 2), DROPOUT_RATES[0], keep1)
    x = F.relu(_conv(x, params["c3"]))
    x = F.relu(_conv(x, params["c4"]))
    x = _dropout(F.max_pool2d(x, 2), DROPOUT_RATES[1], keep2)
    x = x.flatten(1)
    return F.relu(x @ params["fc1"] + params["b1"])


def paper_cnn_forward(params, cfg: CNNConfig, images, dropout=None):
    """images [B,H,W,C] f32 -> logits [B,num_classes]."""
    feats = paper_cnn_features(params, cfg, images, dropout)
    return feats @ params["fc2"] + params["b2"]

