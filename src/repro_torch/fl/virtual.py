"""Virtual centralized model v^{(j)} (paper Section IV).

    v^{(j)} = w^{(j-1)} - eta * tau * grad F(w^{(j-1)})

grad F is approximated with a large pooled batch from the union of the
participating devices' data (the best available surrogate for the global
dataset).  fc_difference(w, v) then measures U_j, making Proposition 1 /
Theorem 1 empirically checkable.
"""
from __future__ import annotations

import torch

from repro_torch.core.cgd import fc_difference  # noqa: F401  (re-export)


def virtual_step(loss_fn, params, global_batch, eta: float, tau: int,
                 dropout=None):
    """loss_fn(params, batch, dropout) -> (loss, aux); params a dict of
    tensors.  Returns (v, grads, loss)."""
    grads, (loss, _) = torch.func.grad_and_value(loss_fn, has_aux=True)(
        params, global_batch, dropout)
    v = {k: p - eta * tau * grads[k].to(p.dtype) for k, p in params.items()}
    return v, grads, loss
