"""The federated LM train step and the serving steps (counterpart of
``repro/fl/distributed.py``).

For tau = 1 a FedCGD round is

    w' = sum_s alpha_s (w - eta grad f_s(w))
       = w - eta sum_s alpha_s grad f_s(w)

i.e. one SGD step on the *schedule-weighted* loss: the per-example loss
weights carry alpha_v * x_v, so an unscheduled silo weighs 0 and the step
itself never changes from round to round.

Each maker takes ``ctx`` (a ``ShardingCtx``, keyword, default None).
With a mesh the params, batch and cache are DTensors placed by
``launch.shardings``'s rules, and the step runs the model under that ctx
(its activations constrained, its kernels on local shards, the MoE
layers expert-parallel); without one every step runs on the device its
tensors lie on, as before.

  make_train_step(cfg, eta, federated, ctx=) -> train_step(params, batch)
                                                -> (new params, metrics)
  make_serve_step(cfg, ctx=)           -> serve_step(params, cache, batch)
  make_prefill_step(cfg, cache_len, ctx=) -> prefill_step(params, batch)
                                             -> (logits [B,1,V], cache)
  silo_weights(schedule_mask, n_silos) -> alpha_v * x_v per silo
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.estimation import tree_leaves, tree_map, tree_norm
from repro_torch.models import transformer as T
from repro_torch.obs import DEFAULT, DISABLED, LayerTrace
from repro_torch.sharding import is_dtensor, sharded_scope


def make_train_step(cfg: ModelConfig, eta: float = 0.1,
                    federated: bool = False, *, ctx=None, obs=None):
    """Returns train_step(params, batch) -> (new params, metrics).

    batch: tokens/targets [B, S] (and an optional loss_mask [B, S]); when
    ``federated``, batch['schedule_weights'] [B] carries alpha_v * x_v per
    example (the examples of silo s all share weight alpha_s).  metrics:
    ce_loss, aux_loss, loss and grad_norm (the L2 norm of every gradient
    in f32), as 0-d tensors on the params' device.  The step is plain SGD,
    p - eta * g in each leaf's dtype; the params passed in are left as
    they were.

    The step holds the params and one set of gradients, never a third
    copy: each period of the stacked blocks is a leaf of its own, a view
    of the stack whose gradient the backward adds in place into a slice
    of one zero-filled stack (never a stacked copy of the periods'
    gradients), and each new leaf is formed in its gradient's buffer
    (``g *= eta``, then ``x - g`` into g: the rounding of ``x - eta *
    g``).

    With DTensor params (``ctx`` with a mesh) the same holds shard by
    shard: each gradient is brought to its param's placements and the
    new leaf formed in its local buffer; the gradient norm is reduced
    over every shard (the same scalar on every rank), and the metrics are
    plain replicated tensors.

    ``obs`` (a ``repro_torch.obs.Obs``; default the process-wide
    ``DEFAULT``, live while a profiler records) traces the step when
    live: an ``lm.step`` span per call over ``lm.trunk``, ``lm.head``
    (the head and CE), ``lm.backward`` (split by a gradient hook on the
    trunk's output into ``lm.head_bwd`` and ``lm.trunk_bwd``) and
    ``lm.update`` (gradients, norm, SGD), each with a CUDA event at both
    ends on the card (``SpanRecord.device_s``).  Not live, the step
    registers no hook, records no event and reads no clock.

    The layers report to an ``obs.LayerTrace``; latent-attention layers
    (moonlight-16b-a3b) add their spans (``lm.mla``, ``lm.moe`` and
    theirs under ``lm.trunk`` and the recompute, ``lm.mla_bwd`` and
    ``lm.moe_bwd`` under ``lm.trunk_bwd``) and, with held experts, two
    more metrics, device tensors:
    ``moe_tokens_held`` (the assignments to held experts, summed over the
    MoE layers) and ``moe_load_max`` (the largest held expert's count in
    the step's worst layer).  ``train_step(params, batch, routing=[])``
    appends each MoE layer's expert choices [B S, k] (int16) to the
    list.
    """
    if obs is None:
        obs = DEFAULT

    def train_step(params, batch, routing=None):
        with sharded_scope(ctx):
            if not obs.enabled:
                return _train_step(params, batch, DISABLED, routing)
            device = batch["targets"].device
            with obs.device_span("lm.step", device):
                return _train_step(params, batch, obs, routing)

    def _train_step(params, batch, obs, routing):
        device = batch["targets"].device if obs.enabled else None
        trace = LayerTrace(obs, batch["targets"].device, routing)
        p = {k: tree_map(_leaf, v) for k, v in params.items()
             if k != "blocks"}
        if "blocks" in params:
            gblocks = tree_map(torch.zeros_like, params["blocks"])
            n = tree_leaves(gblocks)[0].shape[0]
            p["blocks"] = [tree_map(lambda x, g, i=i: _leaf(x[i], g[i]),
                                    params["blocks"], gblocks)
                           for i in range(n)]
        lm_batch = dict(batch)
        if federated:
            w = lm_batch.pop("schedule_weights").to(torch.float32)
            base = lm_batch.get("loss_mask")
            S = batch["targets"].shape[1]
            lm_batch["loss_mask"] = w[:, None] * (
                base if base is not None
                else torch.ones((w.shape[0], S), dtype=torch.float32,
                                device=w.device))
        with torch.enable_grad():
            total, metrics = T._loss_fn(p, cfg, lm_batch, 0.0, ctx, obs,
                                        trace)
            with obs.device_span("lm.backward", device):
                total.backward()
        with torch.no_grad(), obs.device_span("lm.update", device):
            grads = {k: (gblocks if k == "blocks" else tree_map(
                lambda x: torch.zeros_like(x) if x.grad is None else x.grad,
                p[k])) for k in params}
            grads = tree_map(_placed_like, params, grads)
            gnorm = tree_norm(grads)
            new = tree_map(lambda x, g: _sgd(x, g, eta), params, grads)
        metrics = {k: _full(v.detach()) for k, v in metrics.items()}
        metrics.update(loss=_full(total.detach()), grad_norm=_full(gnorm))
        if trace.moe:
            metrics["moe_tokens_held"] = torch.stack(
                [h for h, _ in trace.moe]).sum()
            metrics["moe_load_max"] = torch.stack(
                [m for _, m in trace.moe]).max()
        return new, metrics

    return train_step


def _placed_like(x, g):
    """A DTensor gradient at its param's placements (a partial sum
    reduced, a replicated one sliced); anything else as it is."""
    if is_dtensor(x) and tuple(g.placements) != tuple(x.placements):
        return g.redistribute(x.device_mesh, x.placements)
    return g


def _sgd(x, g, eta):
    """x - eta * g formed in g's buffer (for DTensors, g's local shard;
    g is at x's placements)."""
    if not is_dtensor(x):
        return torch.sub(x, g.mul_(eta), out=g)
    from torch.distributed.tensor import DTensor
    gl = g.to_local()
    torch.sub(x.to_local(), gl.mul_(eta), out=gl)
    return DTensor.from_local(gl, x.device_mesh, x.placements,
                              shape=x.shape, stride=x.stride(),
                              run_check=False)


def _full(x):
    """A replicated (or partial) DTensor as the plain tensor it holds."""
    return x.full_tensor() if is_dtensor(x) else x


def _leaf(x, grad=None):
    """x detached as a leaf of the step's backward; with ``grad``, the
    buffer its gradient is added into."""
    x = x.detach().requires_grad_(True)
    x.grad = grad
    return x


def make_serve_step(cfg: ModelConfig, *, ctx=None):
    """serve_step(params, cache, batch) -> (logits [B,1,V], new cache):
    one decode step (plain torch), with no gradient recorded.  ``batch``
    is passed through whole: ``tokens`` [B,1], or for the audio family
    ``frame_embeddings`` [B,1,encoder_dim]."""

    @torch.no_grad()
    def serve_step(params, cache, batch):
        return T.serve_step(params, cfg, cache, batch, ctx)

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, *, ctx=None):
    """prefill_step(params, batch) -> (logits [B,1,V] of the last
    position, cache for ``cache_len`` positions): the trunk over the
    prompt, then the head on its last position only (the [B,S,V] head is
    never formed).  ``batch`` is passed through whole: ``tokens`` or the
    audio family's ``frame_embeddings``, and the VLM's
    ``encoder_embeddings``, whose keys and values the cache keeps."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with sharded_scope(ctx):
            x, _, cache = T._forward_hidden(params, cfg, batch, True,
                                            cache_len, ctx)
            return T._head(params, cfg, x[:, -1:], ctx), cache

    return prefill_step


def silo_weights(schedule_mask, n_silos: int) -> torch.Tensor:
    """alpha_v * x_v (Eq. 2) for the weighted federated step: with equal
    dataset sizes alpha = mask / sum(mask), scaled by n_silos so that an
    all-ones schedule reproduces the plain unweighted mean loss."""
    m = torch.as_tensor(schedule_mask, dtype=torch.float32)
    return m / torch.clamp(m.sum(), min=1.0) * n_silos
