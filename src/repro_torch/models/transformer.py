"""Decoder of the LM model zoo: every family of the JAX package (dense
GQA, MoE, RG-LRU hybrid, RWKV6, the VLM's cross-attention decoder and the
audio-token decoder).

As in the JAX package, the parameters of the ``num_full_periods`` pattern
periods are stacked on a leading [nper] axis (``params["blocks"]``) and
the remainder layers are ``rem{i}``; here the periods run in a Python
loop over views of the stacked leaves.  Prefill and training run the
hand-written kernels through ``kernels.ops`` (self and cross attention,
the RG-LRU scan, the WKV recurrence; on the card each also runs its
backward kernel); decode is plain torch.  The audio family embeds
``frame_embeddings`` [B,S,encoder_dim] through ``embed_proj`` and adds
sinusoidal positions; the VLM's cross layers attend over
``encoder_embeddings`` [B,num_encoder_tokens,encoder_dim] (through
``enc_proj`` when encoder_dim != d_model), whose keys and values the
prefill caches for decode.

Every function below takes ``ctx`` (a ``ShardingCtx``, default None):
under a mesh the params and inputs are DTensors, each public function
enters ``sharding.sharded_scope`` once (the private ones it calls run
inside it) and the reference's ``constrain`` calls place the activations
(``x`` over ("batch", "sp", None) between layers, the logits over
("batch", None, "sp")).  With ``ctx=None`` nothing changes.

Public API (functional):
    init(gen, cfg)                                  -> params
    forward_hidden(params, cfg, batch, collect_cache, cache_len, ctx)
                                                    -> (hidden, aux, cache)
    forward(params, cfg, batch, collect_cache, cache_len, ctx)
                                                    -> (logits, aux, cache)
    loss_fn(params, cfg, batch, ctx=ctx)            -> (loss, metrics)
    init_cache(cfg, batch_size, cache_len, device)  -> cache
    serve_step(params, cfg, cache, batch, ctx)      -> (logits, cache)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      RECURRENT, RWKV, ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as W
from repro_torch.obs import DISABLED
from repro_torch.sharding import (as_dtensor, constrain, matmul,
                                  partial_where_split, sharded_scope)


def _dtype(cfg: ModelConfig):
    return getattr(torch, cfg.dtype)


def _pdtype(cfg: ModelConfig):
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# nested-dict helpers (the parameter and cache trees)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _put(stack, i, tree, n):
    """Write ``tree`` at index i of the stacked tree ``stack`` [n, ...]
    (allocated at the first write; pass None) and return it.  A stack
    built so holds one tree beside it, where ``torch.stack`` of a list
    holds every tree and the stack: a 54 GB model would need twice that.
    A stack of one is a view of its tree."""
    if n == 1:
        return _map(lambda x: x.unsqueeze(0), tree)
    if stack is None:
        stack = _map(lambda x: x.new_empty((n,) + x.shape), tree)
    _map(lambda s, x: s[i].copy_(x), stack, tree)
    return stack


def _index(tree, i):
    return _map(lambda x: x[i], tree)


def _unbind(tree, n):
    """The n trees of ``tree``'s leading axis."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# init


def init_layer(gen, cfg: ModelConfig, kind: str, out=None):
    """One layer's weights; with ``out`` (a tree of the same leaves, a
    period's slice of the stack) written into it and returned: the
    projections and the FFN, MoE experts included, are drawn straight
    into their leaves, the rest (norms, biases, gates; the RWKV and
    recurrent blocks, at most a few hundred MB) drawn and copied."""
    dt = _pdtype(cfg)
    d = cfg.d_model
    dev = gen.device
    o = out or {}
    if kind == RWKV:
        p = {
            "ln1": W.layer_norm_init(d, dt, dev),
            "tm": W.time_mix_init(gen, cfg, dt),
            "ln2": W.layer_norm_init(d, dt, dev),
            "cm": W.channel_mix_init(gen, cfg, dt),
        }
        return _into(out, p)
    p = {"norm1": L.rms_norm_init(d, dt, dev),
         "norm2": L.rms_norm_init(d, dt, dev)}
    if kind == RECURRENT:
        p["rec"] = R.recurrent_block_init(gen, cfg, dt)
    else:
        p["attn"] = L.attention_params_init(gen, cfg, dt,
                                            cross=(kind == CROSS_ATTN),
                                            out=o.get("attn"))
    p["ffn"] = (M.moe_params_init(gen, cfg, dt, out=o.get("ffn"))
                if cfg.num_experts and kind != RECURRENT
                else L.swiglu_init(gen, d, cfg.d_ff, dt, out=o.get("ffn")))
    return _into(out, p)


def _into(out, tree):
    """``tree`` written into ``out`` (a tree of the same leaves; a leaf
    drawn in place is ``out``'s own and is not copied) and returned;
    ``tree`` itself without ``out``."""
    if out is None:
        return tree

    def put(o, x):
        if x is not o:
            o.copy_(x)
        return o
    return _map(put, out, tree)


def init_period(gen, cfg: ModelConfig, out=None):
    o = out or {}
    return {f"layer{i}": init_layer(gen, cfg, kind, o.get(f"layer{i}"))
            for i, kind in enumerate(cfg.block_pattern)}


def init(gen: torch.Generator, cfg: ModelConfig):
    """Random weights drawn from ``gen`` on its device, in
    ``cfg.param_dtype`` (the JAX package's structure and shapes; its
    threefry values cannot be matched, so parity runs convert the JAX
    package's weights instead).  The periods' stack is allocated first,
    from the shapes of a period drawn under ``FakeTensorMode`` (no memory,
    no numbers drawn), and each period is drawn into its slice: the init
    holds the stack and one layer's small leaves, never a second
    period."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dt = _pdtype(cfg)
    dev = gen.device
    params = {}
    if cfg.family == "audio":
        params["embed_proj"] = L.dense_init(
            gen, (cfg.encoder_dim, cfg.d_model), dtype=dt)
    else:
        params["embed"] = L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                       dtype=dt)
    if cfg.family == "vlm" and cfg.encoder_dim != cfg.d_model:
        params["enc_proj"] = L.dense_init(
            gen, (cfg.encoder_dim, cfg.d_model), dtype=dt)
    n = cfg.num_full_periods
    if n:
        with FakeTensorMode():
            period = init_period(gen, cfg)
        blocks = _map(lambda x: torch.empty((n,) + tuple(x.shape),
                                            dtype=x.dtype, device=dev),
                      period)
        for i in range(n):
            init_period(gen, cfg, out=_index(blocks, i))
        params["blocks"] = blocks
    for i in range(cfg.num_remainder_layers):
        params[f"rem{i}"] = init_layer(gen, cfg, cfg.block_pattern[i])
    params["final_norm"] = (W.layer_norm_init(cfg.d_model, dt, dev)
                            if RWKV in cfg.block_pattern
                            else L.rms_norm_init(cfg.d_model, dt, dev))
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype=dt)
    return params


# ---------------------------------------------------------------------------
# per-layer state (decode cache / recurrent state)


def init_layer_state(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device):
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    if kind == RECURRENT:
        return R.init_recurrent_state(cfg, batch, device)
    if kind == RWKV:
        H, rhd = cfg.num_heads, cfg.rwkv_head_dim
        return {"shift1": torch.zeros((batch, cfg.d_model), dtype=dt,
                                      device=device),
                "shift2": torch.zeros((batch, cfg.d_model), dtype=dt,
                                      device=device),
                "wkv": torch.zeros((batch, H, rhd, rhd), dtype=torch.float32,
                                   device=device)}
    if kind == CROSS_ATTN:
        shape = (batch, cfg.num_encoder_tokens, KV, hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    if kind == GLOBAL_ATTN:
        n = cache_len
    elif kind == LOCAL_ATTN:
        n = min(cfg.window_size, cache_len)
    else:
        raise ValueError(kind)
    return {"k": torch.zeros((batch, n, KV, hd), dtype=dt, device=device),
            "v": torch.zeros((batch, n, KV, hd), dtype=dt, device=device),
            "slot_pos": torch.full((n,), -1, dtype=torch.int32,
                                   device=device),
            "next_slot": torch.zeros((), dtype=torch.int32, device=device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    """Decode cache for the whole model (stacked over periods)."""
    cache = {}
    nper = cfg.num_full_periods
    for pi in range(nper):
        cache["blocks"] = _put(cache.get("blocks"), pi, {
            f"layer{i}": init_layer_state(cfg, kind, batch, cache_len,
                                          device)
            for i, kind in enumerate(cfg.block_pattern)}, nper)
    for i in range(cfg.num_remainder_layers):
        cache[f"rem{i}"] = init_layer_state(cfg, cfg.block_pattern[i],
                                            batch, cache_len, device)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------------------
# layer application


def apply_layer(p, cfg: ModelConfig, kind: str, x, *, enc=None, q_pos=None,
                state=None, decode=False, collect_cache=False,
                cache_len: int = 0, ctx=None):
    """Returns (x, aux_loss, new_state); ``enc`` [B,T,d] are the encoder
    states a cross layer attends over in prefill.  Under ``ctx`` the
    residual stream enters sequence-sharded over the model axis."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_state = state
    B = x.shape[0]
    x = constrain(x, ctx, "batch", "sp", None)

    if kind == RWKV:
        h = W.layer_norm(p["ln1"], x)
        if decode:
            y, s1, wkv = W.time_mix_step(p["tm"], cfg, h, state["shift1"],
                                         state["wkv"])
        else:
            s1_0 = (torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                device=x.device)
                    if state is None else state["shift1"])
            rhd = cfg.rwkv_head_dim
            wkv_0 = (torch.zeros((B, cfg.num_heads, rhd, rhd),
                                 dtype=torch.float32, device=x.device)
                     if state is None else state["wkv"])
            y, s1, wkv = W.time_mix(p["tm"], cfg, h, s1_0, wkv_0, ctx)
        x = x + y
        h = W.layer_norm(p["ln2"], x)
        s2_0 = (torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
                if state is None else state["shift2"])
        y, s2 = W.channel_mix(p["cm"], h, s2_0, ctx)
        x = x + y
        if collect_cache or decode:
            new_state = {"shift1": s1.to(_dtype(cfg)),
                         "shift2": s2.to(_dtype(cfg)), "wkv": wkv}
        return x, aux, new_state

    if kind == RECURRENT:
        h = L.rms_norm(p["norm1"], x)
        s0 = R.init_recurrent_state(cfg, B, x.device) if state is None \
            else state
        y, s = R.recurrent_block(p["rec"], cfg, h, s0, decode=decode,
                                 ctx=ctx)
        x = x + y
        x = x + L.swiglu(p["ffn"], L.rms_norm(p["norm2"], x), act=L.gelu,
                         ctx=ctx)
        return x, aux, (s if (collect_cache or decode) else state)

    h = L.rms_norm(p["norm1"], x)
    window = cfg.window_size if kind == LOCAL_ATTN else 0
    theta = (cfg.rope_theta_local if kind == LOCAL_ATTN else cfg.rope_theta)
    if kind == CROSS_ATTN:
        if decode:
            y, _, _ = L.multihead_attention(p["attn"], cfg, h, causal=False,
                                            cache=state, cache_fixed_kv=True,
                                            ctx=ctx)
        else:
            y, _, (k, v) = L.multihead_attention(p["attn"], cfg, h,
                                                 kv_x=enc, causal=False,
                                                 ctx=ctx)
            if collect_cache:
                new_state = {"k": k.contiguous(), "v": v.contiguous()}
    elif decode:
        y, new_state, _ = L.multihead_attention(
            p["attn"], cfg, h, q_pos=q_pos, causal=True, window=window,
            rope_theta=theta, cache=state, ctx=ctx)
    else:
        y, _, kv = L.multihead_attention(
            p["attn"], cfg, h, q_pos=q_pos, causal=True, window=window,
            rope_theta=theta, ctx=ctx)
        if collect_cache:
            new_state = _prefill_cache(cfg, kind, kv, q_pos, cache_len)
    x = x + y
    h = L.rms_norm(p["norm2"], x)
    if cfg.num_experts:
        y, aux = M.moe_ffn(p["ffn"], cfg, h, ctx)
    else:
        y = L.swiglu(p["ffn"], h, ctx=ctx)
    return x + y, aux, new_state


def _prefill_cache(cfg: ModelConfig, kind: str, kv, q_pos, cache_len: int):
    """Pack prefill-computed KV into a decode cache buffer: when the
    prompt fills the buffer, it keeps the last n keys and the next write
    goes to slot 0 (the oldest)."""
    k, v = kv
    B, S = k.shape[0], k.shape[1]
    n = min(cfg.window_size, cache_len) if kind == LOCAL_ATTN else cache_len
    pos = (q_pos.expand(B, S)[0] if q_pos is not None
           else torch.arange(S, device=k.device)).to(torch.int32)
    if S >= n:
        k, v, pos = k[:, -n:], v[:, -n:], pos[-n:]
        next_slot = torch.zeros((), dtype=torch.int32, device=k.device)
        slot_pos = pos
    else:
        padn = n - S
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, padn))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, padn))
        slot_pos = torch.cat([pos, torch.full((padn,), -1, dtype=torch.int32,
                                              device=k.device)])
        next_slot = torch.tensor(S % n, dtype=torch.int32, device=k.device)
    return {"k": k.contiguous(), "v": v.contiguous(),
            "slot_pos": slot_pos.contiguous(), "next_slot": next_slot}


# ---------------------------------------------------------------------------
# trunk, head and loss


def _embed(params, cfg: ModelConfig, batch, ctx=None):
    """Token embeddings (the audio family: frame_embeddings @ embed_proj)
    times sqrt(d_model), plus sinusoidal positions where the config has
    them, at batch['positions'] (default 0..S-1)."""
    # F.embedding: its backward on CUDA sums a row's gradients in a fixed
    # order (indexing's scatter-add uses atomics), so a train step repeats
    # bit for bit
    dt = _dtype(cfg)
    if cfg.family == "audio":
        x = matmul(batch["frame_embeddings"].to(dt), params["embed_proj"])
    elif ctx is not None and ctx.mesh is not None:
        x = _embed_sharded(batch["tokens"], params["embed"], ctx).to(dt)
    else:
        x = F.embedding(batch["tokens"], params["embed"]).to(dt)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(
        device=x.device, dtype=dt)
    if cfg.pos_embedding == "sinusoidal":
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x = x + L.sinusoidal_pos(pos, cfg.d_model).to(dt)
    return constrain(x, ctx, "batch", "sp", None)


def _embed_sharded(tokens, table, ctx):
    """``F.embedding`` of DTensor tokens [B,S] (batch over the batch axes)
    in a table whose vocab may be split over the model axis
    (vocab-parallel: each model rank looks up the tokens in its rows,
    zeros elsewhere, and the rows are summed over the model axis).  The
    table's d_model dim is first gathered: the batch axes carry the
    tokens.  Returns [B,S,d] over the tokens' placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ctx.mesh
    names = list(mesh.mesh_dim_names)
    tok = constrain(tokens, ctx, "batch", None)
    mi = names.index(ctx.model_axis)
    vocab_split = (mesh.size(mi) > 1
                   and table.shape[0] % mesh.size(mi) == 0)
    tpl = [Replicate()] * mesh.ndim
    if vocab_split:
        tpl[mi] = Shard(0)
    t = tok.to_local()
    # each rank's rows are its own tokens': its table gradient is its
    # part of the sum over the mesh dims that split the tokens
    w = as_dtensor(table, mesh).redistribute(mesh, tpl).to_local(
        grad_placements=partial_where_split(tok.placements, tpl))
    out_pl = list(tok.placements)
    if vocab_split:
        lo = mesh.get_local_rank(mi) * w.shape[0]
        idx = t - lo
        ok = (idx >= 0) & (idx < w.shape[0])
        rows = F.embedding(torch.where(ok, idx, 0), w) \
            * ok[..., None].to(w.dtype)
        out_pl[mi] = Partial()
    else:
        rows = F.embedding(t, w)
    out = DTensor.from_local(rows, mesh, out_pl, run_check=False)
    return out.redistribute(mesh, tok.placements)


def _encoder_states(params, cfg: ModelConfig, batch, ctx=None):
    """The VLM's encoder states [B,T,d] (None for other families)."""
    if cfg.family != "vlm":
        return None
    enc = batch["encoder_embeddings"].to(_dtype(cfg))
    if "enc_proj" in params:
        enc = matmul(enc, params["enc_proj"])
    return constrain(enc, ctx, "batch", None, None)


def _head(params, cfg: ModelConfig, x, ctx=None):
    xn = (W.layer_norm(params["final_norm"], x)
          if RWKV in cfg.block_pattern
          else L.rms_norm(params["final_norm"], x))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = matmul(xn, head, out_dtype=torch.float32)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    # vocab column-parallel in both regimes ("sp" is always the model axis)
    return constrain(logits, ctx, "batch", None, "sp")


def forward_hidden(params, cfg: ModelConfig, batch,
                   collect_cache: bool = False, cache_len: int = 0,
                   ctx=None):
    """The trunk: every layer over batch['tokens'] [B,S] (the audio
    family: batch['frame_embeddings']; the VLM also reads
    batch['encoder_embeddings']).  Returns (final
    hidden [B,S,d] before the head, aux, cache-or-None); with
    ``collect_cache`` the cache holds ``cache_len`` positions for the
    decode that follows.  With ``cfg.remat``, each layer runs under
    ``torch.utils.checkpoint`` when a gradient is being recorded (as the
    JAX package's ``jax.checkpoint``), so the backward recomputes it
    and holds one layer's transients at a time.

    ``params["blocks"]`` comes in one of two forms.  Every caller but the
    train step passes the stacked tree ``init`` makes, unbound here once
    (under autograd, the unbind's backward stacks the periods' gradients
    into one new tensor).  ``fl.distributed.make_train_step`` passes a
    list of period trees whose leaves are leaves of its backward, each
    with a slice of one preallocated stack as its ``.grad``, so that no
    stacked copy of the gradients is made."""
    with sharded_scope(ctx):
        return _forward_hidden(params, cfg, batch, collect_cache, cache_len,
                               ctx)


def _forward_hidden(params, cfg, batch, collect_cache, cache_len, ctx):
    x = _embed(params, cfg, batch, ctx)
    enc = _encoder_states(params, cfg, batch, ctx)
    S = x.shape[1]
    q_pos = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    kw = dict(enc=enc, q_pos=q_pos, collect_cache=collect_cache,
              cache_len=cache_len, ctx=ctx)

    def run(p, kind, x, aux):
        if remat:
            x, a, st = checkpoint(apply_layer, p, cfg, kind, x,
                                  use_reentrant=False, **kw)
        else:
            x, a, st = apply_layer(p, cfg, kind, x, **kw)
        return x, aux + a, st

    cache = {}
    # a stack is unbound once (a view per period would add a zero-filled
    # copy of the whole stack per period to its backward); the train
    # step's list of periods is used as it is
    nper = cfg.num_full_periods
    blocks = params.get("blocks")
    periods = (blocks if isinstance(blocks, list)
               else _unbind(blocks, nper) if nper else [])
    for pi, pparams in enumerate(periods):
        st = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, aux, st[f"layer{i}"] = run(pparams[f"layer{i}"], kind, x, aux)
        if collect_cache:
            cache["blocks"] = _put(cache.get("blocks"), pi, st, nper)
    for i in range(cfg.num_remainder_layers):
        x, aux, st = run(params[f"rem{i}"], cfg.block_pattern[i], x, aux)
        if collect_cache:
            cache[f"rem{i}"] = st
    if collect_cache:
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        return x, aux, cache
    return x, aux, None


def forward(params, cfg: ModelConfig, batch, collect_cache: bool = False,
            cache_len: int = 0, ctx=None):
    """Full-sequence forward of batch['tokens'] [B,S].  Returns (logits
    [B,S,V] f32, aux, cache-or-None)."""
    with sharded_scope(ctx):
        return _forward(params, cfg, batch, collect_cache, cache_len, ctx)


def _forward(params, cfg, batch, collect_cache, cache_len, ctx):
    x, aux, cache = _forward_hidden(params, cfg, batch, collect_cache,
                                    cache_len, ctx)
    return _head(params, cfg, x, ctx), aux, cache


CE_CHUNK = 512


def loss_fn(params, cfg: ModelConfig, batch, label_smoothing: float = 0.0,
            ctx=None):
    """Next-token CE of batch['targets'] [B,S] (weighted by
    batch['loss_mask'] when given) plus the aux loss -> (total, {"ce_loss",
    "aux_loss"}).  Where S * vocab > 2**24 the head and CE run chunk by
    chunk (``_chunked_ce``), so the [B,S,V] f32 logits are never whole."""
    with sharded_scope(ctx):
        return _loss_fn(params, cfg, batch, label_smoothing, ctx)


def _loss_fn(params, cfg, batch, label_smoothing, ctx, obs=DISABLED):
    """``loss_fn`` inside the sharded scope.  With a live ``obs`` the trunk
    and the head run under ``lm.trunk`` / ``lm.head`` spans, and a
    gradient hook on the trunk's output splits an enclosing
    ``lm.backward`` span where the head's backward ends."""
    S = batch["targets"].shape[1]
    big = S * cfg.vocab_size > (1 << 24)
    device = batch["targets"].device if obs.enabled else None
    with obs.device_span("lm.trunk", device):
        x, aux, _ = _forward_hidden(params, cfg, batch, False, 0, ctx)
    if obs.enabled and x.requires_grad:
        x.register_hook(obs.tracer.split_hook("lm.backward", "lm.head_bwd",
                                              "lm.trunk_bwd"))
    with obs.device_span("lm.head", device):
        if big and not cfg.unroll_for_costing:
            loss = _chunked_ce(params, cfg, x, batch["targets"],
                               batch.get("loss_mask"), label_smoothing,
                               ctx=ctx)
        else:
            loss = L.softmax_cross_entropy(_head(params, cfg, x, ctx),
                                           batch["targets"],
                                           batch.get("loss_mask"),
                                           label_smoothing)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


def _chunked_ce(params, cfg: ModelConfig, x, targets, mask,
                label_smoothing: float, chunk: int = CE_CHUNK, ctx=None):
    """The head and CE over sequence chunks of x [B,S,d] (the tail padded
    with zero weight), each chunk under ``torch.utils.checkpoint`` (its
    [B,chunk,V] logits are recomputed in the backward, not kept)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    mask = (torch.ones((B, S), dtype=torch.float32, device=x.device)
            if mask is None else mask.to(torch.float32))
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))

    def body(xi, ti, mi):
        return L.softmax_cross_entropy_sums(_head(params, cfg, xi, ctx), ti,
                                            mi, label_smoothing)

    sums, wsums = [], []
    for c0 in range(0, S + pad, chunk):
        args = (x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        s, w = (checkpoint(body, *args, use_reentrant=False)
                if torch.is_grad_enabled() else body(*args))
        sums.append(s)
        wsums.append(w)
    return torch.stack(sums).sum() / torch.clamp(torch.stack(wsums).sum(),
                                                 min=1.0)


def serve_step(params, cfg: ModelConfig, cache, batch, ctx=None):
    """One decode step: batch['tokens'] [B,1] (the audio family:
    batch['frame_embeddings'] [B,1,encoder_dim], its sinusoidal position
    ``cache['pos']``; cross layers read their cached encoder keys and
    values).  Returns (logits [B,1,V], new cache); the cache passed in is
    left as it was."""
    with sharded_scope(ctx):
        return _serve_step(params, cfg, cache, batch, ctx)


def _serve_step(params, cfg, cache, batch, ctx):
    pos = cache["pos"]
    x = _embed(params, cfg, {**batch, "positions": pos.reshape(1, 1)}, ctx)
    B = x.shape[0]
    q_pos = pos.reshape(1, 1).expand(B, 1)

    def run(p, kind, x, state):
        x, _, st = apply_layer(p, cfg, kind, x, q_pos=q_pos, state=state,
                               decode=True, ctx=ctx)
        return x, st

    new_cache = {}
    nper = cfg.num_full_periods
    for pi in range(nper):
        pparams = _index(params["blocks"], pi)
        pstate = _index(cache["blocks"], pi)
        st = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, st[f"layer{i}"] = run(pparams[f"layer{i}"], kind, x,
                                     pstate[f"layer{i}"])
        new_cache["blocks"] = _put(new_cache.get("blocks"), pi, st, nper)
    for i in range(cfg.num_remainder_layers):
        x, new_cache[f"rem{i}"] = run(params[f"rem{i}"],
                                      cfg.block_pattern[i], x,
                                      cache[f"rem{i}"])
    new_cache["pos"] = pos + 1
    logits = _head(params, cfg, x, ctx)
    return logits, new_cache
