"""Flat-npz checkpoints of nested dicts of tensors (counterpart of
``repro/checkpoint/ckpt.py``; the files cross-load both ways).

Keys are the leaves' paths joined by ``/`` (list and tuple items by
index), as the reference writes them, and ``metadata`` goes to
``<path>.meta.json``.  A bf16 leaf is written as its two-byte bit
patterns under numpy's ``|V2`` descr, the bytes the reference's
``np.savez`` writes for an ``ml_dtypes`` bf16 array, and read back bit
for bit from either package's file; numpy has no bf16, so no other
form keeps the bits without ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

BF16_BITS = np.dtype("V2")


def _flatten(tree, prefix=""):
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    flat = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(BF16_BITS)
    return x.numpy()


def save_pytree(path: str, tree: Any, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: _to_numpy(v) for k, v in _flatten(tree).items()})
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def _leaf(arr: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype == BF16_BITS:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(dtype=like.dtype, device=like.device)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure, dtypes and devices of ``like``."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return _leaf(data[prefix[:-1]], node)

    return build(like, "")
