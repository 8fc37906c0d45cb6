"""Shared neural-net primitives of the port's models (PyTorch, functional).

Parameters are plain dicts of tensors in the JAX package's layouts
(``wq`` [d, H, hd], ``wo`` [H, hd, d]), so weights carry across with a
dtype and device move (``repro_torch.convert``).  Attention prefill goes
through ``kernels.ops.attention`` (the hand-written kernel on a CUDA
tensor, its plain version on the CPU); decode attends over the ring
buffer in plain torch, as the JAX package's ``_attend`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.sharding import (ShardingCtx, as_dtensor, constrain,
                                  is_dtensor, matmul, resolve_spec)

# ---------------------------------------------------------------------------
# init helpers (drawn from an explicit generator, on its device)


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32, out=None):
    """N(0, scale^2) of ``shape`` (scale 1/sqrt(fan_in) by default); with
    ``out`` (a tensor of that shape) drawn straight into it, the same
    numbers (``randn`` is ``normal_`` on a new tensor)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
    return out.normal_(generator=gen).mul_(scale)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    return dense_init(gen, shape, scale=0.02, dtype=dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# norms


def rms_norm_init(dim, dtype, device):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rms_norm(params, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].to(torch.float32))).to(dtype)


def group_norm(x, num_groups, eps: float = 1e-5, scale=None, bias=None):
    """GroupNorm over the last dim (used by RWKV6 wkv output)."""
    dtype = x.dtype
    d = x.shape[-1]
    g = x.reshape(x.shape[:-1] + (num_groups, d // num_groups)).to(
        torch.float32)
    mean = g.mean(-1, keepdim=True)
    var = g.var(-1, keepdim=True, correction=0)
    g = (g - mean) * torch.rsqrt(var + eps)
    g = g.reshape(x.shape)
    if scale is not None:
        g = g * scale.to(torch.float32)
    if bias is not None:
        g = g + bias.to(torch.float32)
    return g.to(dtype)


# ---------------------------------------------------------------------------
# positions


def rope(x, positions, theta: float):
    """x [..., S, H, hd]; positions [..., S] (broadcastable).  Half-split
    rotation; sin/cos are cast to x's dtype before it, as in the JAX
    package."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None, None].to(torch.float32) * freq
    sin = torch.sin(angles).to(x.dtype)
    cos = torch.cos(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_pos(positions, dim):
    """positions [...] int -> [..., dim] f32: sin then cos of position x
    10000^(-i / (dim/2 - 1)), i < dim/2."""
    half = dim // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                     * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention


def attention_params_init(gen, cfg: ModelConfig, dtype, cross: bool = False,
                          out=None):
    """wq/wk/wv/wo; ``bq``/``bk``/``bv`` (zeros) with ``cfg.qkv_bias``,
    ``q_norm``/``k_norm`` with ``cfg.qk_norm``, and for a cross layer the
    f32 scalar ``gate`` (0: tanh(0) closes it), as the JAX package's.
    With ``out`` (a tree of the same leaves) the projections are drawn
    into its leaves."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    o = out or {}
    p = {
        "wq": dense_init(gen, (d, H, hd), dtype=dtype, out=o.get("wq")),
        "wk": dense_init(gen, (d, KV, hd), dtype=dtype, out=o.get("wk")),
        "wv": dense_init(gen, (d, KV, hd), dtype=dtype, out=o.get("wv")),
        "wo": dense_init(gen, (H, hd, d), scale=1.0 / math.sqrt(H * hd),
                         dtype=dtype, out=o.get("wo")),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((heads, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd, dtype, dev)
        p["k_norm"] = rms_norm_init(hd, dtype, dev)
    if cross:
        p["gate"] = torch.zeros((), dtype=torch.float32, device=dev)
    return p


def _expand_kv(k, H):
    """[B,T,KV,hd] -> [B,T,H,hd]: query head h reads key head h // (H/KV)."""
    G = H // k.shape[2]
    return k if G == 1 else k.repeat_interleave(G, dim=2)


def _mask_bias(q_pos, k_pos, window: int, causal: bool):
    """Additive f32 bias [B, S, T] from positions q_pos [B,S], k_pos [B,T]."""
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > (qp - window))
    ok = ok & (kp >= 0)   # slots with pos -1 are invalid (ring buffer)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, -1e30)


def _attend(q, k, v, bias):
    """q [B,S,H,hd], k/v [B,T,H,hd], bias [B,S,T]: dense softmax in f32,
    probs cast to v's dtype before the product with v (as ``_attend``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = scores + bias[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def _project(x, w):
    """x [B,S,d] @ w [d,H,hd] -> contiguous [B,S,H,hd]."""
    return matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def multihead_attention(params, cfg: ModelConfig, x, *, kv_x=None,
                        q_pos=None, causal=True, window=0, rope_theta=None,
                        cache=None, cache_fixed_kv=False,
                        ctx: Optional[ShardingCtx] = None):
    """GQA attention.  x [B,S,d]; q_pos [B or 1, S] int; ``kv_x``
    [B,T,d] (default x) feeds the keys and values (cross attention).

    The QKV biases follow the projections, QK norm comes before rope
    (rope only with ``q_pos``), and a ``gate`` scales the output by
    tanh(gate).  Prefill (``cache`` None) runs ``ops.attention`` with
    queries and keys at positions 0..S-1 (causal and window masks) or,
    for cross attention, non-causal over the T encoder keys.  Decode
    (``cache`` given, S == 1): the new key and value are written into the
    ring buffer {'k','v','slot_pos','next_slot'} at ``next_slot`` and
    attention runs over the buffer, masked by each slot's position; with
    ``cache_fixed_kv`` it attends over the cached keys and values {'k',
    'v'} (cross attention's, from the prefill) and writes nothing.
    Returns (out [B,S,d], new_cache or None, (k, v) after norm and
    rope).

    Under ``ctx`` (the reference's two regimes): context-parallel
    (``tp`` False, or ``hybrid``) with S > 1 shards the queries over the
    sequence ("sp") and keeps the keys and values whole; else the heads
    go over "model" and, in decode, the cache length over "seq".  The
    reference expands K/V to H heads before it constrains them; here the
    kernel keeps GQA, so the key heads are sharded with their query heads
    where KV divides the model axis, and expanded to H only where it
    does not."""
    B, S = x.shape[:2]
    H = cfg.num_heads
    q = _project(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    fresh_kv = not (cache is not None and cache_fixed_kv)
    if fresh_kv:
        src = x if kv_x is None else kv_x
        k = _project(src, params["wk"])
        v = _project(src, params["wv"])
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
    else:
        k, v = cache["k"], cache["v"]
    if "q_norm" in params:
        q = rms_norm(params["q_norm"], q)
        if fresh_kv:
            k = rms_norm(params["k_norm"], k)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    if cfg.pos_embedding == "rope" and q_pos is not None:
        q = rope(q, q_pos, theta)
        if fresh_kv:
            k = rope(k, q_pos, theta)

    new_cache = None
    if cache is not None and cache_fixed_kv:
        new_cache = cache
    elif cache is not None:
        k, v, slot_pos = _write_slot(cache, k, v, q_pos)
        new_cache = {"k": k, "v": v, "slot_pos": slot_pos,
                     "next_slot": (cache["next_slot"] + 1) % k.shape[1]}
    kv = (k, v)          # after norm and rope, before any expansion
    if ctx is not None and ctx.mesh is not None:
        q, k, v = _constrain_qkv(q, k, v, ctx, H)
    if cache is not None and cache_fixed_kv:
        bias = torch.zeros((B, S, k.shape[1]), dtype=torch.float32,
                           device=x.device)
        out = _attend(q, _expand_kv(k, H), _expand_kv(v, H), bias)
    elif cache is not None:
        bias = _mask_bias(q_pos.expand(B, S).to(torch.int32),
                          slot_pos[None, :].expand(B, -1), window, causal)
        out = _attend(q, _expand_kv(k, H), _expand_kv(v, H), bias)
    else:
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            window=window).transpose(1, 2)
    wo = params["wo"]
    out = matmul(out.flatten(2), wo.reshape(-1, wo.shape[-1]))
    if "gate" in params:
        out = out * torch.tanh(params["gate"]).to(out.dtype)
    return out, new_cache, kv


def _write_slot(cache, k, v, q_pos):
    """The decode step's ring-buffer write at ``next_slot``, as an
    elementwise select over the buffer (a new buffer, as an out-of-place
    ``index_copy`` would make), so that a buffer split over its length
    takes it on every rank."""
    n = cache["k"].shape[1]
    at = torch.arange(n, device=k.device) == cache["next_slot"]
    k = torch.where(at[None, :, None, None], k, cache["k"])
    v = torch.where(at[None, :, None, None], v, cache["v"])
    pos = q_pos.reshape(-1)[:1].to(torch.int32)
    return k, v, torch.where(at, pos, cache["slot_pos"])


def _constrain_qkv(q, k, v, ctx: ShardingCtx, H: int):
    """q [B,S,H,hd], k/v [B,T,KV,hd] at the reference's placements
    (``multihead_attention``'s docstring)."""
    S = q.shape[1]
    if (not ctx.tp or ctx.hybrid) and S > 1:
        q = constrain(q, ctx, "batch", "sp", None, None)
        k = constrain(k, ctx, "batch", None, None, None)
        v = constrain(v, ctx, "batch", None, None, None)
        return q, k, v
    q = constrain(q, ctx, "batch", None, "model", None)
    heads = resolve_spec(q.shape, ctx, ("batch", None, "model", None))[2]
    if heads is not None and k.shape[2] % ctx.axis_size(
            (heads,) if isinstance(heads, str) else heads):
        k, v = _expand_kv(k, H), _expand_kv(v, H)
    seq = "seq" if S == 1 else None
    k = constrain(k, ctx, "batch", seq, "model", None)
    v = constrain(v, ctx, "batch", seq, "model", None)
    return q, k, v


# ---------------------------------------------------------------------------
# MLPs


def swiglu_init(gen, d, dff, dtype, out=None):
    o = out or {}
    return {
        "w_gate": dense_init(gen, (d, dff), dtype=dtype, out=o.get("w_gate")),
        "w_up": dense_init(gen, (d, dff), dtype=dtype, out=o.get("w_up")),
        "w_down": dense_init(gen, (dff, d), dtype=dtype, out=o.get("w_down")),
    }


def swiglu(params, x, act=F.silu, ctx: Optional[ShardingCtx] = None):
    """Under ``ctx``: d_ff column-parallel with TP (not hybrid), else
    token-parallel over the model axis (the reference's ``swiglu``)."""
    h = act(matmul(x, params["w_gate"])) * matmul(x, params["w_up"])
    if ctx is not None and ctx.tp and not ctx.hybrid:
        h = constrain(h, ctx, "batch", None, "sp")
    else:
        h = constrain(h, ctx, "batch", "sp", None)
    return matmul(h, params["w_down"])


# ---------------------------------------------------------------------------
# losses


def _token_losses(logits, targets, label_smoothing):
    """Each position's CE in f32: logsumexp minus the target's logit (a
    one-hot select; for a DTensor ``_ce_terms_sharded``)."""
    logits = logits.to(torch.float32)
    if not is_dtensor(logits):
        logz = torch.logsumexp(logits, dim=-1)
        onehot = (torch.arange(logits.shape[-1], device=logits.device)
                  == targets[..., None])
        true_logit = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    else:
        logz, true_logit = _ce_terms_sharded(logits, targets)
    loss = logz - true_logit
    if label_smoothing:
        loss = (1 - label_smoothing) * loss + label_smoothing * (
            logz - logits.mean(dim=-1))
    return loss


def _ce_terms_sharded(logits, targets):
    """(logsumexp, the target's logit) of DTensor logits [..., C] whose C
    may be split over mesh dims (vocab-parallel): each rank reduces its
    own classes (a max, then its sum of exp(x - max)) and gathers the
    targets in its class range, and the partial results are combined
    over the mesh dims that split C.  DTensor's own logsumexp gathers C
    whole (a [B, chunk, V] f32 copy a rank), and its one-hot or gather
    forms a global-batch tensor or fails when the batch is split too.
    The split sequence is ``torch.logsumexp``'s: log(sum(exp(x - m))) +
    m, with m = 0 where it is infinite; with C whole it is
    ``torch.logsumexp`` itself (its backward too, so a one-rank mesh
    gives the unsharded loss's bits)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = logits.device_mesh
    c = logits.ndim - 1
    if any(isinstance(p, Partial) for p in logits.placements):
        logits = logits.redistribute(mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in logits.placements])
    split = [isinstance(p, Shard) and p.dim == c for p in logits.placements]
    tpl = [Replicate() if sp else p
           for sp, p in zip(split, logits.placements)]

    def combined(x, op):
        out = [Partial(op) if sp else p for sp, p in zip(split, tpl)]
        return DTensor.from_local(x, mesh, out, shape=targets.shape,
                                  stride=targets.stride(),
                                  run_check=False).redistribute(mesh, tpl)

    local = logits.to_local()
    if any(sp and mesh.size(i) > 1 for i, sp in enumerate(split)):
        m = combined(local.detach().amax(-1), "max").to_local()
        m = m.masked_fill(m.abs() == float("inf"), 0)[..., None]
        logz = torch.log(combined(torch.exp(local - m).sum(-1), "sum")) \
            + DTensor.from_local(m[..., 0], mesh, tpl, shape=targets.shape,
                                 stride=targets.stride(), run_check=False)
    else:
        logz = torch.logsumexp(logits, dim=-1)    # C whole on every rank
    t = as_dtensor(targets, mesh).redistribute(mesh, tpl).to_local()
    _, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)
    idx = t - offset[c]
    ok = (idx >= 0) & (idx < local.shape[-1])
    val = torch.gather(local, -1, torch.where(ok, idx, 0)[..., None])[..., 0]
    return logz, combined(torch.where(ok, val, 0.0), "sum")


def softmax_cross_entropy(logits, targets, mask=None, label_smoothing=0.0):
    """logits [..., C]; targets int [...]. Returns the mean over mask."""
    loss = _token_losses(logits, targets, label_smoothing)
    if mask is None:
        return loss.mean()
    mask = mask.to(torch.float32)
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def softmax_cross_entropy_sums(logits, targets, mask=None,
                               label_smoothing=0.0):
    """(weighted loss sum, weight sum): the chunked CE's building block."""
    loss = _token_losses(logits, targets, label_smoothing)
    mask = (torch.ones_like(loss) if mask is None
            else mask.to(torch.float32))
    return (loss * mask).sum(), mask.sum()
