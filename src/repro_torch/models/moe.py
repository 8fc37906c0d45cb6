"""Mixture-of-Experts FFN: top-k routing with a sort-based, capacity-bounded
dispatch (counterpart of ``repro/models/moe.py``).

Without a mesh every expert is local.  Under a ``ShardingCtx`` whose
model axis divides the experts, the layer runs expert-parallel (the
reference's ``shard_map`` path): the tokens are split over the batch
axes and whole over "model"; each model rank routes its tokens over all
experts, runs ``_moe_local`` on its E / n_model experts (assignments to
other experts go to a scratch bin) with the capacity of its own tokens,
after its expert weights are all-gathered over the FSDP axes they are
stored sharded on; ``y`` is summed over "model" and the load-balance
statistics are averaged over the batch axes.  The collectives are
DTensor redistributions (autograd carries them backward).  Where the
model axis does not divide the experts, the layer falls back to every
expert local on the whole batch, as the reference does.

Routing decisions follow the JAX package's exactly: the router logits are
f32 sums of the products of x and the router in x's dtype (never rounded
to bf16), top-k breaks ties at the lower expert index, and an
assignment's arrival rank within its expert comes from a stable sort of
the flattened (token, slot) order, so the last tokens of the batch are
the first dropped when an expert is over capacity.  The expert products
are ``torch.bmm`` (no TPU kernel covers MoE: the JAX package computes
them with ``einsum`` too).

The dispatch (each slot's token, ``x_pad[src]``) and the combine (each
token's k slots, ``y_flat[slot]``) are ``torch.autograd.Function``s whose
backward is a gather in a fixed order (``_Dispatch``, ``_Combine``), so
that a train step on the card is bitwise repeatable by the port's own
code.  Autograd's backward of an index is an accumulating scatter
(``index_put_`` with ``accumulate=True``), whose order is the library's:
torch 2.11 sorts the indices on CUDA, and the plain gathers' backward
repeated bit for bit on an H100, so these guard against a torch whose
scatter adds in another order, not against a fault seen today.  Their
forwards are the plain gathers, bitwise.

The sigmoid router of DeepSeek-V3 (moonlight-16b-a3b, ``moe_ffn_held``)
is a second path that leaves the one above as it is.  The router runs in
f32 (x cast to f32 against the f32 router, a full-f32 product), scores s
= sigmoid(logits); the choice is the top k of s + b (b the correction
bias ``router_bias``, a buffer the train step leaves as it is; a stable
descending sort, ties at the lower index), the weights the chosen s
normalised to sum to one and times ``routed_scaling``.  The layer holds
experts [expert_lo, expert_lo + experts_held) of the E it routes over
(one device's share of an expert-parallel layer) and computes their part
of the result only, for the tokens routed to them, dropping nothing.  The
dispatch is a stable sort of the T k assignments by held expert (the
others after them, in a scratch group), so each expert's tokens are a
contiguous run in token order; the expert products are
``torch._grouped_mm`` over the runs' offsets (no padding, no host sync:
the buffer has T k rows, every assignment's possible place, and the rows
past the held runs are never read).  The combine sums a token's held
slots in slot order in f32 (``_CombineHeld``), and its backward, like
``_Dispatch``'s, gathers in a fixed order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, swiglu, swiglu_init
from repro_torch.obs import LayerTrace, in_backward
from repro_torch.sharding import (as_dtensor, matmul, partial_where_split,
                                  resolve_spec, spec_to_placements)


def moe_params_init(gen, cfg: ModelConfig, dtype, out=None):
    """The router [d, E] in f32, the experts' SwiGLU weights stacked on a
    leading [E] axis, and the ``shared`` / ``dense_residual`` SwiGLUs
    where the config has them; with ``out`` (a tree of the same leaves)
    each is drawn into its leaf."""
    return _moe_params_init(gen, cfg, dtype, cfg.num_experts, out)


def held_params_init(gen, cfg, dtype, out=None):
    """``moe_params_init``'s leaves for the sigmoid router over the held
    experts (``moe_ffn_held``): the experts' weights on a leading
    [num_held] axis, and the correction bias ``router_bias`` [E], f32
    zeros."""
    return _moe_params_init(gen, cfg, dtype, cfg.num_held, out, bias=True)


def _moe_params_init(gen, cfg, dtype, held, out, bias=False):
    d, dff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    o = out or {}
    p = {
        "router": dense_init(gen, (d, E), scale=0.02, dtype=torch.float32,
                             out=o.get("router")),
        "w_gate": dense_init(gen, (held, d, dff), scale=1 / math.sqrt(d),
                             dtype=dtype, out=o.get("w_gate")),
        "w_up": dense_init(gen, (held, d, dff), scale=1 / math.sqrt(d),
                           dtype=dtype, out=o.get("w_up")),
        "w_down": dense_init(gen, (held, dff, d), scale=1 / math.sqrt(dff),
                             dtype=dtype, out=o.get("w_down")),
    }
    if bias:
        p["router_bias"] = torch.zeros((E,), dtype=torch.float32,
                                       device=gen.device)
    if cfg.num_shared_experts:
        p["shared"] = swiglu_init(gen, d, cfg.num_shared_experts * dff, dtype,
                                  out=o.get("shared"))
    if cfg.moe_dense_ff:
        p["dense_residual"] = swiglu_init(gen, d, cfg.moe_dense_ff, dtype,
                                          out=o.get("dense_residual"))
    return p


def _capacity(tokens: int, k: int, num_experts: int, factor: float) -> int:
    """Capacity per expert, floored at min(tokens, 32): a decode step (a
    token a sequence) never drops an assignment."""
    cap = int(math.ceil(tokens * k / num_experts * factor))
    return max(cap, min(tokens, 32))


def top_k_routing(router_logits, k):
    """router_logits [T,E] -> (weights [T,k] f32, experts [T,k] int64,
    probs [T,E] f32).  Ties go to the lower expert index (a stable
    descending sort), as ``jax.lax.top_k``; the k weights are normalised
    to sum to 1."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    weights = torch.gather(probs, 1, experts)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, experts, probs


def _positions_in_expert(flat_experts, num_experts):
    """Each assignment's arrival rank within its expert, in the order of
    ``flat_experts`` [N] (int in [0, E)).  Returns (pos [N], group sizes
    [E])."""
    n = flat_experts.shape[0]
    order = torch.argsort(flat_experts, stable=True)
    group_sizes = _counts(flat_experts, num_experts, torch.long)
    group_start = torch.cumsum(group_sizes, 0) - group_sizes
    pos_sorted = (torch.arange(n, device=flat_experts.device)
                  - group_start[flat_experts[order]])
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos, group_sizes


def _counts(idx, n: int, dtype):
    """How often each of 0..n-1 occurs in ``idx`` [N], in ``dtype`` (a
    sum of ones: integers, exact and in any order the same; unlike
    ``bincount`` it has a meta kernel, for the dry run)."""
    return torch.zeros((n,), dtype=dtype, device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=dtype, device=idx.device))


def _expert_ffn(params, x_buf):
    """x_buf [E, cap, d] -> [E, cap, d]: each expert's SwiGLU."""
    h = F.silu(torch.bmm(x_buf, params["w_gate"])) \
        * torch.bmm(x_buf, params["w_up"])
    return torch.bmm(h, params["w_down"])


def _router_logits(params, x):
    """x [T,d] against the router cast to x's dtype, summed in f32: the
    products of two bf16 numbers are exact in f32, so this is the JAX
    package's ``preferred_element_type=f32`` product."""
    return matmul(x.to(torch.float32),
                  params["router"].to(x.dtype).to(torch.float32))


class _Dispatch(torch.autograd.Function):
    """x [T, d] -> x_buf [n_slots, d], slot s holding token src[s] (row T:
    zeros).  Backward: dx[t] = sum over j = 0..k-1, in order, of d
    x_buf[slot[t, j]], summed in f32 and rounded once; a dropped
    assignment (slot n_slots, the scratch) adds nothing."""

    @staticmethod
    def forward(ctx, x, src, slot_2d):
        ctx.save_for_backward(slot_2d)
        x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
        return x_pad[src]

    @staticmethod
    def backward(ctx, g):
        slot_2d, = ctx.saved_tensors
        g_pad = torch.cat([g, g.new_zeros((1, g.shape[1]))], dim=0)
        dx = g_pad[slot_2d[:, 0]].to(torch.float32)
        for j in range(1, slot_2d.shape[1]):
            dx = dx + g_pad[slot_2d[:, j]].to(torch.float32)
        return dx.to(g.dtype), None, None


class _Combine(torch.autograd.Function):
    """y_flat [n_slots, d], w_2d [T, k] -> y [T, d] = sum over j, in slot
    order, of y_flat[idx[:, j]] * w_2d[:, j], in y_flat's dtype (idx: the
    slots, a dropped one clamped to a real slot with weight 0).
    Backward, one term a slot: d y_flat[s] = w_slot[s] * dy[src[s]] (an
    empty slot 0), read through the dispatch's inverse map ``src``; dw[t,
    j] = <dy[t], y_flat[idx[t, j]]>.  ``slot_flat`` [T k] places the
    weights on their slots (a dropped one on the scratch slot)."""

    @staticmethod
    def forward(ctx, y_flat, w_2d, idx, src, slot_flat):
        ctx.save_for_backward(y_flat, w_2d, idx, src, slot_flat)
        y = y_flat.new_zeros((idx.shape[0], y_flat.shape[1]))
        for j in range(idx.shape[1]):
            y = y + y_flat[idx[:, j]] * w_2d[:, j, None]
        return y

    @staticmethod
    def backward(ctx, dy):
        y_flat, w_2d, idx, src, slot_flat = ctx.saved_tensors
        n_slots = y_flat.shape[0]
        dw = torch.stack([(dy * y_flat[idx[:, j]]).sum(-1)
                          for j in range(idx.shape[1])], dim=1)
        w_slot = w_2d.new_zeros((n_slots + 1,))
        w_slot[slot_flat] = w_2d.reshape(-1)
        dy_pad = torch.cat([dy, dy.new_zeros((1, dy.shape[1]))], dim=0)
        dy_flat = dy_pad[src] * w_slot[:n_slots, None]
        return dy_flat, dw, None, None, None


def _moe_local(params, cfg: ModelConfig, x, capacity, expert_lo: int = 0,
               num_local: int | None = None):
    """Dispatch and expert compute over experts [expert_lo, expert_lo +
    num_local) (all E by default; ``params``' expert tables hold just
    those) for tokens x [T,d].  Returns (y [T,d], me [E], ce [E]), as the
    JAX package's; y sums the local experts' outputs only."""
    T, d = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    nl = E if num_local is None else num_local
    weights, experts, probs = top_k_routing(_router_logits(params, x), k)

    flat_e = experts.reshape(-1)                               # [N = T k]
    local_e = flat_e - expert_lo
    is_local = (local_e >= 0) & (local_e < nl)
    # assignments to other ranks' experts go to a scratch bin nl, so they
    # never take an arrival rank of a local expert
    pos, _ = _positions_in_expert(torch.where(is_local, local_e, nl),
                                  nl + 1)
    fits = is_local & (pos < capacity)
    # the source token of each (expert, slot); an assignment past its
    # expert's capacity (or another rank's) writes the scratch slot
    # n_slots, which is cut off
    n_slots = nl * capacity
    slot_flat = torch.where(fits, local_e * capacity + pos, n_slots)
    token_idx = torch.arange(T * k, device=x.device) // k
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=x.device)
    src[slot_flat] = token_idx
    src = src[:n_slots]
    slot_2d = slot_flat.reshape(T, k)
    x_buf = _Dispatch.apply(x, src, slot_2d).reshape(nl, capacity, d)

    y_flat = _expert_ffn(params, x_buf).reshape(n_slots, d)

    # combine: one gather a top-k slot, added in slot order in x's dtype
    w_2d = (weights.reshape(-1) * fits.to(torch.float32)).reshape(
        T, k).to(x.dtype)
    y = _Combine.apply(y_flat, w_2d, torch.clamp(slot_2d, 0, n_slots - 1),
                       src, slot_flat)

    # switch-style load-balance statistics over all experts
    me = probs.mean(dim=0)
    ce = _counts(flat_e, E, torch.float32) / (T * k)
    return y, me, ce


def moe_ffn(params, cfg: ModelConfig, x, ctx=None):
    """x [B,S,d] -> (y [B,S,d], aux loss f32 scalar)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    if ctx is None or ctx.mesh is None:
        capacity = _capacity(B * S, k, E, cfg.capacity_factor)
        y, me, ce = _moe_local(params, cfg, x.reshape(B * S, d), capacity)
        y = y.reshape(B, S, d)
    else:
        y, me, ce = _moe_sharded(params, cfg, x, ctx)
    aux = cfg.router_aux_loss * E * torch.sum(me * ce)
    if "shared" in params:
        y = y + swiglu(params["shared"], x, ctx=ctx)
    if "dense_residual" in params:
        y = y + swiglu(params["dense_residual"], x, ctx=ctx)
    return y, aux


def _moe_sharded(params, cfg: ModelConfig, x, ctx):
    """The layer on DTensors (module docstring) -> (y [B,S,d], me, ce) as
    DTensors: y split over the batch axes, me and ce replicated.

    Each rank's local computation covers its own tokens (and, expert-
    parallel, its own experts), so the local operands it reads whole are
    taken with ``Partial`` gradient placements there: their gradients
    are summed over the ranks that split the work.  ``me`` is the mean of
    the router's probabilities over every token: expert-parallel, formed
    on the DTensors (autograd's mean over the split batch); with every
    expert local, each rank's own (the same on every rank, and the
    unsharded layer's bits on a one-rank mesh).  ``ce`` counts
    assignments and carries no gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ctx.mesh
    names = list(mesh.mesh_dim_names)
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    n_model = ctx.model_axis_size
    if E % max(n_model, 1) != 0:
        n_model = 1   # replicated experts for odd reductions
    rep = [Replicate()] * mesh.ndim
    x = as_dtensor(x, mesh)
    mi = names.index(ctx.model_axis)
    if n_model == 1:
        # every expert local on the whole batch (the reference's
        # single-program path): tokens and tables gathered, the same
        # computation on every rank
        tok = tuple(rep)
    else:
        tok = spec_to_placements(
            mesh, resolve_spec(x.shape, ctx, ("batch", None, None)))
    split = list(tok)                  # how the local work is divided
    if n_model > 1:
        split[mi] = Shard(0)
    xs = x.redistribute(mesh, tok)
    xl = xs.to_local(grad_placements=partial_where_split(split, tok))
    tokens = xl.shape[0] * S
    capacity = _capacity(tokens, k, E, cfg.capacity_factor)

    def local(w, pl):
        return as_dtensor(w, mesh).redistribute(mesh, pl).to_local(
            grad_placements=partial_where_split(split, pl))

    experts = list(rep)
    if n_model > 1:
        experts[mi] = Shard(0)
    w = {"router": local(params["router"], rep)}
    for name in ("w_gate", "w_up", "w_down"):
        w[name] = local(params[name], experts)
    lo, nl = 0, None
    if n_model > 1:
        nl = E // n_model
        lo = mesh.get_local_rank(ctx.model_axis) * nl
    y, me, ce = _moe_local(w, cfg, xl.reshape(tokens, d), capacity, lo, nl)
    ypl = list(tok)
    if n_model > 1:
        ypl[mi] = Partial()            # each model rank's experts' part
    y = DTensor.from_local(y.reshape(xl.shape), mesh, ypl,
                           run_check=False).redistribute(mesh, tok)
    stat = [Partial("avg") if isinstance(p, Shard) else Replicate()
            for p in tok]
    ce = DTensor.from_local(ce, mesh, stat, run_check=False).redistribute(
        mesh, rep)
    if n_model == 1:
        # the whole batch on every rank: its own me, replicated
        return y, DTensor.from_local(me, mesh, rep, run_check=False), ce
    probs = torch.softmax(_router_logits(
        {"router": as_dtensor(params["router"], mesh)},
        xs.reshape(B * S, d)).to(torch.float32), dim=-1)
    return y, probs.mean(dim=0).redistribute(mesh, rep), ce


# ---------------------------------------------------------------------------
# the sigmoid router over held experts (DeepSeek-V3; module docstring)


def sigmoid_routing(logits, bias, k: int, scaling: float):
    """logits [T,E] f32, bias [E] -> (weights [T,k] f32, experts [T,k]
    int64): the top k of sigmoid(logits) + bias (ties at the lower
    index), weighted by their scores normalised and times ``scaling``."""
    s = torch.sigmoid(logits)
    experts = torch.sort(s.detach() + bias, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    w = torch.gather(s, 1, experts)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * scaling, experts


def grouped_mm(x, w, offs):
    """x [N, a] @ w[g] for the rows of each run g (runs end at ``offs``
    [G], int32; rows past the last run are left unwritten) -> [N, b]."""
    return torch._grouped_mm(x, w, offs=offs)


class _CombineHeld(torch.autograd.Function):
    """y_buf [N, d] (the sorted assignments' expert outputs; rows past
    the held runs unwritten), w [T, k] f32, pos [T, k] (each assignment's
    row), held [T, k], src [N] (each row's token; T for a row of no held
    assignment), w_sorted [N] (each row's weight, 0 past the held runs)
    -> y [T, d] f32 = sum over the held j, in slot order, of y_buf[pos[:,
    j]] w[:, j].  Backward: d y_buf[p] = w_sorted[p] dy[src[p]]; dw[t, j]
    = <dy[t], y_buf[pos[t, j]]> where held, else 0."""

    @staticmethod
    def forward(ctx, y_buf, w, pos, held, src, w_sorted):
        ctx.save_for_backward(y_buf, pos, held, src, w_sorted)
        y = torch.zeros((pos.shape[0], y_buf.shape[1]), dtype=torch.float32,
                        device=y_buf.device)
        for j in range(pos.shape[1]):
            y = y + torch.where(held[:, j, None],
                                y_buf[pos[:, j]].float() * w[:, j, None],
                                0.0)
        return y

    @staticmethod
    def backward(ctx, dy):
        y_buf, pos, held, src, w_sorted = ctx.saved_tensors
        dw = torch.stack([torch.where(held[:, j], (dy * y_buf[pos[:, j]]
                                                   .float()).sum(-1), 0.0)
                          for j in range(pos.shape[1])], dim=1)
        dy_pad = torch.cat([dy, dy.new_zeros((1, dy.shape[1]))], dim=0)
        d_buf = (dy_pad[src] * w_sorted[:, None]).to(y_buf.dtype)
        return d_buf, dw, None, None, None, None


def moe_ffn_held(params, cfg, x, trace=None):
    """x [B,S,d] -> [B,S,d]: the held experts' part of the sigmoid-routed
    MoE (module docstring) plus the shared experts.  ``trace`` (a
    ``obs.LayerTrace``) gets the spans ``lm.moe.route`` and
    ``lm.moe.experts`` and, in the forward, the layer's counters and
    (where asked) its expert choices."""
    trace = trace or LayerTrace()
    B, S, d = x.shape
    T, k = B * S, cfg.experts_per_token
    nh, lo = cfg.num_held, cfg.expert_lo
    N = T * k
    xf = x.reshape(T, d)
    with trace.span("lm.moe.route"):
        logits = matmul(xf.to(torch.float32), params["router"])
        w, experts = sigmoid_routing(logits, params["router_bias"], k,
                                     cfg.routed_scaling)
        local = experts.reshape(-1) - lo
        held = (local >= 0) & (local < nh)
        key = torch.where(held, local, nh)
        order = torch.argsort(key, stable=True)
        counts = _counts(key, nh + 1, torch.long)
        offs = torch.cumsum(counts[:nh], 0).to(torch.int32)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(N, device=x.device)
        slot = torch.where(held, rank, N)       # a row, or the scratch N
        token = torch.arange(N, device=x.device) // k
        src = torch.where(held[order], token[order], T)
        w_sorted = torch.where(held, w.detach().reshape(-1), 0.0)[order]
        x_buf = _Dispatch.apply(xf, src, slot.reshape(T, k))
    if not in_backward():
        trace.moe.append((counts[:nh].sum(), counts[:nh].max()))
        if trace.routing is not None:
            trace.routing.append(experts.to(torch.int16))
    with trace.span("lm.moe.experts"):
        h = F.silu(grouped_mm(x_buf, params["w_gate"], offs)) \
            * grouped_mm(x_buf, params["w_up"], offs)
        y_buf = grouped_mm(h, params["w_down"], offs)
    held2 = held.reshape(T, k)
    y = _CombineHeld.apply(y_buf, w, torch.where(held, rank, 0).reshape(
        T, k), held2, src, w_sorted)
    y = y + swiglu(params["shared"], x).reshape(T, d).float()
    return y.to(x.dtype).reshape(B, S, d)
