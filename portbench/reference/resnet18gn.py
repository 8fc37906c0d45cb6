"""ResNet-18 with GroupNorm (He et al. arXiv:1512.03385, every BatchNorm a
GroupNorm as in Wu & He arXiv:1803.08494), CIFAR stem: a 3x3 stride-1
convolution and no max-pool; global average pool and a linear head.

Plain PyTorch in f32, written from the papers and the port's parameter
layout (NHWC images, OIHW kernels, "SAME" padding that puts an odd pad
after the input, GroupNorm over 8 groups with the population variance and
eps 1e-5).  ``rnd``, where given, rounds each convolution's and
product's operands first (the control's lower precision).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))   # (channels, stride)


def blocks(stem=64):
    """(key prefix, in channels, out channels, stride, projection) of the
    eight basic blocks, in forward order."""
    cin = stem
    for si, (cout, stride) in enumerate(STAGES):
        for bi in range(2):
            s = stride if bi == 0 else 1
            yield f"s{si}b{bi}", cin, cout, s, s != 1 or cin != cout
            cin = cout


def _same(n, k, stride):
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1, rnd=None):
    if rnd is not None:
        x, w = rnd(x), rnd(w)
    (t, b), (left, right) = (_same(n, k, stride)
                             for n, k in zip(x.shape[-2:], w.shape[-2:]))
    return F.conv2d(F.pad(x, (left, right, t, b)), w, stride=stride)


def features(params, images, groups=8, rnd=None):
    """images [B, H, W, C] -> pooled features [B, 512]."""
    def gn(x, s, b):
        return F.group_norm(x, groups, params[s], params[b], eps=1e-5)

    x = images.permute(0, 3, 1, 2)
    x = F.relu(gn(conv(x, params["stem"], 1, rnd), "gn_s", "gn_b"))
    for p, _, _, stride, proj in blocks():
        h = F.relu(gn(conv(x, params[f"{p}.conv1"], stride, rnd),
                      f"{p}.gn1_s", f"{p}.gn1_b"))
        h = gn(conv(h, params[f"{p}.conv2"], 1, rnd), f"{p}.gn2_s",
               f"{p}.gn2_b")
        if proj:
            x = gn(conv(x, params[f"{p}.proj"], stride, rnd), f"{p}.gnp_s",
                   f"{p}.gnp_b")
        x = F.relu(x + h)
    return x.mean((2, 3))


def head(params, feats, rnd=None):
    w = params["fc"]
    if rnd is not None:
        feats, w = rnd(feats), rnd(w)
    return feats @ w + params["fc_b"]
