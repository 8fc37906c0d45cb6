"""Edge-server aggregation (paper Eq. 2) + the fused finalize core.

``aggregate`` is the reference eager implementation; the trainer's
round hot path goes through ``make_finalize_core``, which computes Eq. 2
and the Eq. 12 centered-gradient norms in one call batched over a
leading cell axis (same op order as ``aggregate``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.estimation import tree_map, tree_row_norms


def _bcast(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (like.dim() - 1))


def aggregate(device_params, mask: np.ndarray, weights: np.ndarray = None):
    """Weighted FedAvg over scheduled devices.

    device_params: tree with leading [V] device dim (the local update's
    output); mask [V] bool; weights default alpha_v = 1/|Pi| (equal
    dataset sizes, paper Sec. V-A)."""
    mask = np.asarray(mask, dtype=np.float64)
    s = mask.sum()
    if s == 0:
        raise ValueError(
            "aggregate() called with an all-False schedule mask — "
            "averaging zero uploads would silently zero the model; the "
            "caller must keep the previous round's params instead "
            "(see FederatedTrainer.run_round's zero-upload path)")
    if weights is None:
        weights = mask / max(s, 1.0)
    else:
        weights = np.asarray(weights) * mask
        weights = weights / max(weights.sum(), 1e-12)

    def agg(leaf):
        w = torch.as_tensor(weights, dtype=torch.float32, device=leaf.device)
        return (leaf.to(torch.float32) * _bcast(w, leaf)).sum(0) \
            .to(leaf.dtype)

    return tree_map(agg, device_params)


def make_finalize_core(tau: int, eta: float):
    """Fused server-side finalize, batched over cells.

    Returns ``core(params, dev_params, deltas, w, active)``: ``params``
    [C, ...] the pre-round models, ``dev_params`` / ``deltas`` [C, V, ...]
    the round core's outputs (with any sanitizer replacements already
    scattered in), ``w`` [C, V] f32 tensor of Eq. 2 upload weights
    (upload_v / |uploads|, all-zero rows for zero-upload cells) and
    ``active`` [C] host bools (True = this cell aggregates).  Per cell:

      new_params [C, ...]  Eq. 2 weighted sum where the cell had uploads,
                           else the previous params
      norms      [C, V]    || grad_v - sum_u w_u grad_u || with
                           grad_v = -delta_v / (tau * eta) — the Eq. 12
                           numerators; rows with w_v = 0 are garbage and
                           must be masked by the caller

    Do not ``torch.compile`` this: see the centering note below."""

    def one_cell(params, dev_params, deltas, w, active):
        if active:
            new_params = {k: (x.to(torch.float32) * _bcast(w, x)).sum(0)
                          .to(x.dtype) for k, x in dev_params.items()}
        else:
            new_params = params

        # Eq. 12 numerators: ||grad_v - mean|| with grad = -delta/(tau*eta).
        # Centering commutes with the scale, so the deltas are centered
        # RAW and the norms divided afterwards: with exact {0, 1/|U|}
        # weights a single-upload cell's centered row is then exactly
        # zero (d_r - d_r), so its norm is exactly 0 and the host-side
        # `g > 0` refresh guard skips it.  Dividing first (or letting a
        # compiler reassociate the division through the weighted mean)
        # leaves ulp-level residue that turns the zero into ~1e-7 and
        # silently collapses g_hat.
        centered = {k: x - (x * _bcast(w, x).to(x.dtype)).sum(0)[None]
                    for k, x in deltas.items()}
        return new_params, tree_row_norms(centered) / (tau * eta)

    def core(params_c, dev_params_c, deltas_c, w_c, active_c):
        outs = [one_cell({k: x[c] for k, x in params_c.items()},
                         {k: x[c] for k, x in dev_params_c.items()},
                         {k: x[c] for k, x in deltas_c.items()},
                         w_c[c], bool(active_c[c]))
                for c in range(len(active_c))]
        new_params = {k: torch.stack([o[0][k] for o in outs])
                      for k in outs[0][0]}
        return new_params, torch.stack([o[1] for o in outs])

    return core
