"""The paper's vision models (Section VI-A), functional PyTorch.

- paper_cnn: 2x[conv3x3-32]+pool+drop(0.2), 2x[conv3x3-64]+pool+drop(0.3),
  FC-120-ReLU, FC-num_classes.
- resnet18_gn: ResNet-18 with every BatchNorm replaced by GroupNorm
  (CIFAR stem: 3x3 stride-1 conv, no max-pool), global average pool,
  FC-num_classes.

Images come in as NHWC [B, H, W, C] (the layout of ``repro``'s datasets
and models) and are viewed as NCHW for the convolutions; conv weights
are OIHW.  The paper CNN's flatten before ``fc1`` runs in (c, h, w)
order, so ``fc1``'s rows are in that order (the JAX model flattens NHWC,
(h, w, c); ``repro_torch.convert`` permutes).  The ResNet's parameters
are one flat dict, its blocks' leaves under keys such as
``"s2b0.conv1"`` (the JAX model nests them; ``convert`` maps the two).

Dropout takes boolean keep masks drawn by the caller (one per dropout
layer, shapes from ``dropout_shapes``): ``torch.func.vmap`` cannot draw
per-device randomness from an explicit generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig

KINDS = ("paper_cnn", "resnet18_gn")
DROPOUT_RATES = (0.2, 0.3)


def channel_widths(cfg: CNNConfig):
    # width may be fractional (micro models): channel counts round to >= 1
    return (max(1, int(round(32 * cfg.width))),
            max(1, int(round(64 * cfg.width))))


def _normal(generator, shape, std):
    return torch.randn(shape, generator=generator) * std


def _conv_init(generator, k, cin, cout):
    """He-normal OIHW kernel [cout, cin, k, k]."""
    return _normal(generator, (cout, cin, k, k), math.sqrt(2 / (k * k * cin)))


def init_paper_cnn(generator: torch.Generator, cfg: CNNConfig):
    """He-normal init on the CPU generator's stream (parameters are
    moved to their device by the caller)."""
    c32, c64 = channel_widths(cfg)
    flat = (cfg.image_size // 4) ** 2 * c64
    g = generator
    return {
        "c1": _conv_init(g, 3, cfg.channels, c32),
        "c2": _conv_init(g, 3, c32, c32),
        "c3": _conv_init(g, 3, c32, c64),
        "c4": _conv_init(g, 3, c64, c64),
        "fc1": _normal(g, (flat, 120), math.sqrt(2 / flat)),
        "b1": torch.zeros(120),
        "fc2": _normal(g, (120, cfg.num_classes), 0.1),
        "b2": torch.zeros(cfg.num_classes),
    }


def dropout_shapes(cfg: CNNConfig, batch_size: int):
    """Shapes of the keep masks ``paper_cnn_forward`` takes (empty when
    the config has no dropout, and for the ResNet, which has none)."""
    if not cfg.dropout or cfg.kind != "paper_cnn":
        return ()
    c32, c64 = channel_widths(cfg)
    s = cfg.image_size
    return ((batch_size, c32, s // 2, s // 2),
            (batch_size, c64, s // 4, s // 4))


def _same(n, k, stride):
    """JAX's ``"SAME"`` padding (before, after) of one spatial axis."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """NCHW convolution with JAX's ``"SAME"`` padding: the output is
    ceil(H / stride) high, and where the padding is odd the extra row
    and column go after the input (a 3x3 stride-2 conv on an even input
    pads (0, 1), not (1, 1) as ``padding=1`` would)."""
    (top, bottom), (left, right) = (
        _same(n, k, stride) for n, k in zip(x.shape[-2:], w.shape[-2:]))
    if (top, left) == (bottom, right):
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


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


# ---------------------------------------------------------------------------
# ResNet18-GN

STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]     # (channels, stride)
FEATURES = STAGES[-1][0]


def _blocks():
    """(key prefix, in channels, out channels, stride of its first conv,
    has a projection) of each of the eight basic blocks, in forward
    order."""
    cin = 64
    for si, (cout, stride) in enumerate(STAGES):
        for bi in range(2):
            s = stride if bi == 0 else 1
            yield f"s{si}b{bi}", cin, cout, s, s != 1 or cin != cout
            cin = cout


def init_resnet18_gn(generator: torch.Generator, cfg: CNNConfig):
    """He-normal convs, ``fc`` [512, C] at std 0.05, GN scales one and
    biases zero, on the CPU generator's stream; one flat dict."""
    params = {"stem": _conv_init(generator, 3, cfg.channels, 64),
              "gn_s": torch.ones(64), "gn_b": torch.zeros(64),
              "fc": _normal(generator, (FEATURES, cfg.num_classes), 0.05),
              "fc_b": torch.zeros(cfg.num_classes)}
    for prefix, cin, cout, _, proj in _blocks():
        params[f"{prefix}.conv1"] = _conv_init(generator, 3, cin, cout)
        params[f"{prefix}.gn1_s"] = torch.ones(cout)
        params[f"{prefix}.gn1_b"] = torch.zeros(cout)
        params[f"{prefix}.conv2"] = _conv_init(generator, 3, cout, cout)
        params[f"{prefix}.gn2_s"] = torch.ones(cout)
        params[f"{prefix}.gn2_b"] = torch.zeros(cout)
        if proj:
            params[f"{prefix}.proj"] = _conv_init(generator, 1, cin, cout)
            params[f"{prefix}.gnp_s"] = torch.ones(cout)
            params[f"{prefix}.gnp_b"] = torch.zeros(cout)
    return params


def _gn(x, scale, bias, groups, eps=1e-5):
    """GroupNorm over (channels of a group, H, W) of NCHW ``x``, in f32
    with the population variance, as the JAX model's ``_gn``.  Plain ops
    only, so ``torch.func.vmap`` batches it without a per-sample
    fallback."""
    n, c, h, w = x.shape
    g = x.reshape(n, groups, c // groups, h, w).to(torch.float32)
    mean = g.mean((2, 3, 4), keepdim=True)
    var = torch.square(g - mean).mean((2, 3, 4), keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    return (g.reshape(x.shape) * scale[:, None, None]
            + bias[:, None, None]).to(x.dtype)


def _block_fwd(params, prefix, x, stride, proj, groups):
    def p(name):
        return params[f"{prefix}.{name}"]
    h = F.relu(_gn(_conv(x, p("conv1"), stride), p("gn1_s"), p("gn1_b"),
                   groups))
    h = _gn(_conv(h, p("conv2")), p("gn2_s"), p("gn2_b"), groups)
    if proj:
        x = _gn(_conv(x, p("proj"), stride), p("gnp_s"), p("gnp_b"), groups)
    return F.relu(x + h)


def resnet18_gn_features(params, cfg: CNNConfig, images):
    """images [B,H,W,C] -> globally pooled features [B,512]."""
    g = cfg.gn_groups
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_gn(_conv(x, params["stem"]), params["gn_s"], params["gn_b"],
                   g))
    for prefix, _, _, stride, proj in _blocks():
        x = _block_fwd(params, prefix, x, stride, proj, g)
    return x.mean((2, 3))


def resnet18_gn_forward(params, cfg: CNNConfig, images):
    """images [B,H,W,C] f32 -> logits [B,num_classes]."""
    return resnet18_gn_features(params, cfg, images) @ params["fc"] \
        + params["fc_b"]


# ---------------------------------------------------------------------------
# dispatch on cfg.kind


def init_cnn(generator: torch.Generator, cfg: CNNConfig):
    if cfg.kind == "paper_cnn":
        return init_paper_cnn(generator, cfg)
    return init_resnet18_gn(generator, cfg)


def cnn_forward(params, cfg: CNNConfig, images, dropout=None):
    """Logits of either model; ``dropout`` (keep masks) reaches only the
    paper CNN: the ResNet has no dropout."""
    if cfg.kind == "paper_cnn":
        return paper_cnn_forward(params, cfg, images, dropout)
    return resnet18_gn_forward(params, cfg, images)
