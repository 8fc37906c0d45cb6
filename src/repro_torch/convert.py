"""Weights carried across between ``repro`` (JAX) and ``repro_torch``.

The paper CNN's conv kernels are HWIO in JAX and OIHW here.  ``fc1``'s
rows follow the flatten order before it: (h, w, c) in the JAX model
(NHWC), (c, h, w) here (NCHW), so they are permuted.  ``fc2``, ``b1``
and ``b2`` carry over unchanged.  Only numpy crosses the boundary.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.device import resolve_device
from repro_torch.models.cnn import channel_widths

_CONVS = ("c1", "c2", "c3", "c4")


def _fc1_grid(cfg: CNNConfig):
    s = cfg.image_size // 4
    return s, s, channel_widths(cfg)[1]


def params_from_jax(np_params: Dict[str, np.ndarray], cfg: CNNConfig,
                    device=None) -> Dict[str, torch.Tensor]:
    """JAX paper-CNN params (as numpy arrays) -> the port's tensors."""
    dev = resolve_device(device)
    out = {}
    for k, v in np_params.items():
        v = np.array(v, dtype=np.float32)
        if k in _CONVS:
            v = v.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
        elif k == "fc1":
            h, w, c = _fc1_grid(cfg)
            v = v.reshape(h, w, c, -1).transpose(2, 0, 1, 3) \
                .reshape(h * w * c, -1)                 # rows (h,w,c)->(c,h,w)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    return out


def params_to_jax(params: Dict[str, torch.Tensor],
                  cfg: CNNConfig) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_jax``: numpy arrays in the JAX layout."""
    out = {}
    for k, t in params.items():
        v = t.detach().cpu().numpy()
        if k in _CONVS:
            v = v.transpose(2, 3, 1, 0)                 # OIHW -> HWIO
        elif k == "fc1":
            h, w, c = _fc1_grid(cfg)
            v = v.reshape(c, h, w, -1).transpose(1, 2, 0, 3) \
                .reshape(h * w * c, -1)
        out[k] = np.ascontiguousarray(v)
    return out
