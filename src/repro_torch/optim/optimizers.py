"""Minimal functional optimizers over nested dicts of tensors
(counterpart of ``repro/optim/optimizers.py``, the same API).

FedAvg's local update (paper Eq. 1) is plain SGD; momentum and AdamW
serve the non-federated training entry points.  ``update`` returns the
updates and the new state and changes nothing in place; AdamW's moments
are f32 whatever the params' dtype.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.estimation import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params) -> (updates, new state)
    update: Callable[[Any, Any, Any], tuple]


def sgd(learning_rate: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum == 0.0:
            return tree_map(lambda g: -learning_rate * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -learning_rate * m, new_m), new_m

    return Optimizer(init, update)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"m": z, "v": tree_map(torch.clone, z),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}

    def update(grads, state, params):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], g32)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], g32)
        mh = tree_map(lambda m: m / (1 - b1 ** tf), m)
        vh = tree_map(lambda v: v / (1 - b2 ** tf), v)
        upd = tree_map(
            lambda mh, vh, p: (-learning_rate
                               * (mh / (torch.sqrt(vh) + eps)
                                  + weight_decay * p.to(torch.float32))
                               ).to(p.dtype),
            mh, vh, params)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def make_optimizer(name: str, learning_rate: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(learning_rate, **kw)
    if name == "adamw":
        return adamw(learning_rate, **kw)
    raise ValueError(name)
