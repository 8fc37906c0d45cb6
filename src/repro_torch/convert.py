"""Weights carried across between ``repro`` (JAX) and ``repro_torch``.

The LM zoo keeps the JAX package's layouts (``wq`` [d, H, hd], ``wo``
[H, hd, d], ``conv_kernel`` [W, lru], periods stacked on a leading axis
under ``blocks``, remainder layers as ``rem{i}``), so its conversion is a
dtype-preserving move of every leaf of the nested dict.

The vision models' conv kernels are HWIO in JAX and OIHW here.  The
paper CNN's ``fc1`` rows follow the flatten order before it: (h, w, c)
in the JAX model (NHWC), (c, h, w) here (NCHW), so they are permuted;
``fc2``, ``b1`` and ``b2`` carry over unchanged.  ResNet18-GN's JAX
params nest each block's leaves under its name (``{"s2b0": {"conv1":
...}}``); here they are one flat dict (``"s2b0.conv1"``), every 4-D leaf
a conv kernel, and ``fc``, ``fc_b`` and the GroupNorm leaves unchanged.
Only numpy crosses the boundary.
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


def _flatten(tree, prefix=""):
    """Nested dict -> flat dict with ``"."``-joined keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    """Inverse of ``_flatten``."""
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _is_conv(k: str, v: np.ndarray, cfg: CNNConfig) -> bool:
    return k in _CONVS if cfg.kind == "paper_cnn" else v.ndim == 4


def params_from_jax(np_params: Dict, cfg: CNNConfig,
                    device=None) -> Dict[str, torch.Tensor]:
    """JAX vision-model params (numpy arrays; the ResNet's nested) -> the
    port's flat dict of tensors."""
    dev = resolve_device(device)
    out = {}
    for k, v in _flatten(np_params).items():
        v = np.array(v, dtype=np.float32)
        if _is_conv(k, v, cfg):
            v = v.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
        elif k == "fc1":
            h, w, c = _fc1_grid(cfg)
            v = v.reshape(h, w, c, -1).transpose(2, 0, 1, 3) \
                .reshape(h * w * c, -1)                 # rows (h,w,c)->(c,h,w)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    return out


def cell_params_from_jax(np_params_c: Dict[str, np.ndarray], cfg: CNNConfig,
                        device=None) -> Dict[str, torch.Tensor]:
    """The JAX multi-cell engine's stacked cell params (numpy leaves
    [C, ...]) -> the port's stacked [C, ...] tree, by ``params_from_jax``
    per cell."""
    flat = _flatten(np_params_c)
    C = len(next(iter(flat.values())))
    per = [params_from_jax({k: np.asarray(x[c]) for k, x in flat.items()},
                           cfg, device)
           for c in range(C)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def params_to_jax(params: Dict[str, torch.Tensor],
                  cfg: CNNConfig) -> Dict:
    """Inverse of ``params_from_jax``: numpy arrays in the JAX layout (the
    ResNet's nested)."""
    out = {}
    for k, t in params.items():
        v = t.detach().cpu().numpy()
        if _is_conv(k, v, cfg):
            v = v.transpose(2, 3, 1, 0)                 # OIHW -> HWIO
        elif k == "fc1":
            h, w, c = _fc1_grid(cfg)
            v = v.reshape(c, h, w, -1).transpose(1, 2, 0, 3) \
                .reshape(h * w * c, -1)
        out[k] = np.ascontiguousarray(v)
    return _nest(out)


def _leaf_to_torch(a, dev) -> torch.Tensor:
    a = np.array(a)                       # a writable copy
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16, by its bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:         # exact in f32
        t = t.to(torch.float32)
    return np.ascontiguousarray(t.numpy())


def lm_params_from_jax(np_params, device=None):
    """``repro.models.transformer.init``'s params (a nested dict of numpy
    arrays, bf16 as ml_dtypes' bfloat16) -> the port's tensors, same
    layouts and dtypes."""
    dev = resolve_device(device)
    if isinstance(np_params, dict):
        return {k: lm_params_from_jax(v, dev) for k, v in np_params.items()}
    return _leaf_to_torch(np_params, dev)


def lm_params_to_jax(params):
    """Inverse of ``lm_params_from_jax``: nested numpy arrays in the JAX
    layouts (bf16 leaves come back as f32, which holds them exactly;
    ``jnp.asarray(a, jnp.bfloat16)`` restores them bit for bit)."""
    if isinstance(params, dict):
        return {k: lm_params_to_jax(v) for k, v in params.items()}
    return _leaf_to_numpy(params)
