"""Client-side local update (paper Eq. 1): tau mini-batch SGD steps.

``make_local_update`` returns a function that runs every available
device's local update at once with ``torch.func.vmap`` over the device
axis — the single-host simulation analogue of devices computing in
parallel.  The forward and the input gradients run as one batch; each
device's weight gradient is a group of a grouped convolution.  A loop
over the devices (plain convolutions, one device after another) lost to
it on the H100 on both vision models: ResNet18-GN's round core took
363-390 ms against 129, the paper CNN's 57-62 against 9-11
(``scripts/local_update_paths.py``, PERF.md).

``make_round_core`` fuses the client half of a round — local update
(Eq. 1), per-device sigma estimation (Eq. 10), model deltas, their L2
norms and NaN/Inf flags — into one call batched over a leading *cell*
axis, whose outputs stay on the device, so the trainer pulls everything
scheduling needs in a single device->host sync.  ``FederatedTrainer``
calls it with one cell; ``MultiCellTrainer`` drives C cells per
aggregation step through the same call.

Dropout randomness cannot be drawn from an explicit generator inside
``vmap``, so the caller draws the keep masks (leaves [V, tau, ...]) and
passes them in.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.estimation import tree_leaves, tree_row_norms


def make_local_update(loss_fn: Callable, eta: float, tau: int):
    """loss_fn(params, batch, dropout) -> (loss, metrics).

    Returns update(params, batches, dropout) where ``batches`` is a dict
    whose leaves have leading dims [num_devices, tau, batch, ...] and
    ``dropout`` a tuple of keep masks [num_devices, tau, ...] (or ());
    every device starts from the same params (edge model broadcast).
    Returns the device params (leading [num_devices] dim) and the mean
    loss per device [num_devices]."""
    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def one_device(params, dev_batches, dev_dropout):
        p = params
        losses = []
        for t in range(tau):
            batch = {k: x[t] for k, x in dev_batches.items()}
            drop = tuple(m[t] for m in dev_dropout) or None
            grads, (loss, _) = grad_fn(p, batch, drop)
            p = {k: p[k] - eta * grads[k].to(p[k].dtype) for k in p}
            losses.append(loss)
        return p, torch.stack(losses).mean()

    def update(params, batches, dropout=()):
        return torch.func.vmap(lambda b, d: one_device(params, b, d))(
            batches, tuple(dropout))

    return update


def make_round_core(loss_fn: Callable, sigma_fn: Callable, eta: float,
                    tau: int):
    """Fused round core, batched over cells.

    loss_fn(params, batch, dropout) -> (loss, metrics);
    sigma_fn(params_c, images [C, V, b, ...], labels [C, V, b]) -> [C, V]
    sigma_v (Eq. 10 for every device of every cell given, in one call).

    Returns core(params, batches, dropout) where ``params`` has a
    leading [C] cell axis, ``batches`` leaves [C, V, tau, batch, ...] and
    ``dropout`` a tuple of keep masks [C, V, tau, ...] (or ()).  Per cell:

      dev_params  [C, V, ...]  post-local-update device models
      losses      [C, V]       mean local loss per device
      sigma_v     [C, V]       Eq. 10 on each device's first batch, at
                               the pre-update params
      deltas      [C, V, ...]  dev_params - params (the upload payload)
      delta_norms [C, V]       per-device L2 norms of the deltas
      finite      [C, V] bool  every delta leaf is finite (the server's
                               NaN/Inf guard, computed on the device so
                               the sanitizer needs no extra round-trip)

    all on the device.  The cell axis is a loop: each cell runs the
    single-cell local update, deltas, norms and flags, so a cell's
    numbers equal a standalone trainer's (a ``vmap`` over the cells lost
    1.4x on the H100, where it turns every convolution into a grouped one
    over C*V groups; PERF.md).  ``sigma_fn`` is called once for all
    cells: one launch of its kernel covers every device of every cell."""
    update = make_local_update(loss_fn, eta, tau)

    def one_cell(params, batches, dropout):
        dev_params, losses = update(params, batches, dropout)
        deltas = {k: dev_params[k] - params[k][None] for k in params}
        delta_norms = tree_row_norms(deltas)
        finite = None
        for x in tree_leaves(deltas):
            f = torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
            finite = f if finite is None else finite & f
        return dev_params, losses, deltas, delta_norms, finite

    def core(params_c, batches_c, dropout_c=()):
        num_cells = tree_leaves(params_c)[0].shape[0]
        outs = [one_cell({k: x[c] for k, x in params_c.items()},
                         {k: x[c] for k, x in batches_c.items()},
                         tuple(m[c] for m in dropout_c))
                for c in range(num_cells)]
        stacked = []
        for i, first in enumerate(outs[0]):
            if isinstance(first, dict):
                stacked.append({k: torch.stack([o[i][k] for o in outs])
                                for k in first})
            else:
                stacked.append(torch.stack([o[i] for o in outs]))
        dev_params, losses, deltas, norms, finite = stacked
        sigma_v = sigma_fn(params_c, batches_c["images"][:, :, 0],
                           batches_c["labels"][:, :, 0])
        return dev_params, losses, sigma_v, deltas, norms, finite

    return core


def set_devices(stacked, idx, trees_stacked):
    """Write many devices' trees into the stacked [V, ...] buffer with one
    scatter per leaf: ``idx`` [K] device indices, ``trees_stacked`` a
    tree with leading [K] axis.  Returns a new tree."""
    out = {}
    for k, s in stacked.items():
        i = torch.as_tensor(idx, dtype=torch.long, device=s.device)
        out[k] = s.index_copy(0, i, trees_stacked[k].to(s.dtype))
    return out


def payload_bits(params, bits_per_param: int = 32) -> float:
    """D_w: uplink payload size of one model update."""
    return sum(x.numel() for x in tree_leaves(params)) * bits_per_param
