"""Latent attention (MLA, DeepSeek-V2/V3; moonlight-16b-a3b) and the layer
that carries it: MLA, then a dense SwiGLU (the leading layers) or the
sigmoid-routed MoE of ``models/moe.py``.

For a token with input h (after the layer's RMSNorm), without a query
LoRA (Moonlight has none):

    q         = h W_q                  H heads x [q_nope | q_rope]
    [c | k_r] = h W_kva                kv_lora_rank + rope
    c         = RMSNorm(c)
    [k_nope | v] = c W_kvb             H heads x [k_nope | v]
    q_rope, k_r = RoPE(q_rope), RoPE(k_r)     k_r shared by every head
    o = softmax([q_nope | q_rope] . [k_nope | k_r] / sqrt(nope + rope),
                causal) v
    out = o W_o

The attention runs through ``kernels.ops.attention`` with q and k at nope
+ rope (192) and v at v_head_dim (128), on the card K4 and K4-bwd at that
pair.  RoPE is the port's own (``layers.rope``: the halves of the rope
channels rotated); HF's DeepSeek-V3 interleaves them, a fixed permutation
of W_q's and W_kva's rope columns.  Parameters: ``wq`` [d, H, nope +
rope], ``wkv_a`` [d, kv_lora_rank + rope], ``kv_norm`` {scale
[kv_lora_rank]}, ``wkv_b`` [kv_lora_rank, H, nope + v], ``wo`` [H, v, d].

A layer reports its spans and MoE counters to an ``obs.LayerTrace``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.obs import LayerTrace
from repro_torch.sharding import matmul


def mla_params_init(gen, cfg, dtype, out=None):
    """One layer's latent attention; with ``out`` drawn into its leaves."""
    d, H = cfg.d_model, cfg.num_heads
    r, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    rope, vd = cfg.qk_rope_head_dim, cfg.v_head_dim
    o = out or {}
    return {
        "wq": L.dense_init(gen, (d, H, nope + rope), dtype=dtype,
                           out=o.get("wq")),
        "wkv_a": L.dense_init(gen, (d, r + rope), dtype=dtype,
                              out=o.get("wkv_a")),
        "kv_norm": L.rms_norm_init(r, dtype, gen.device),
        "wkv_b": L.dense_init(gen, (r, H, nope + vd), dtype=dtype,
                              out=o.get("wkv_b")),
        "wo": L.dense_init(gen, (H, vd, d), scale=1.0 / math.sqrt(H * vd),
                           dtype=dtype, out=o.get("wo")),
    }


def mla_layer_init(gen, cfg, dense: bool, dtype, out=None):
    """One layer's params: the norms, the latent attention and the FFN, a
    SwiGLU of ``cfg.dense_ff`` where ``dense``, else the held experts'
    MoE; with ``out`` drawn into its leaves."""
    d, o = cfg.d_model, out or {}
    return {
        "norm1": L.rms_norm_init(d, dtype, gen.device),
        "attn": mla_params_init(gen, cfg, dtype, out=o.get("attn")),
        "norm2": L.rms_norm_init(d, dtype, gen.device),
        "ffn": (L.swiglu_init(gen, d, cfg.dense_ff, dtype, out=o.get("ffn"))
                if dense else
                M.held_params_init(gen, cfg, dtype, out=o.get("ffn")))}


def mla(p, cfg, h, q_pos):
    """h [B,S,d] (normed) at positions q_pos [1 or B, S] -> [B,S,d]."""
    B, S, _ = h.shape
    H, r = cfg.num_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = L._project(h, p["wq"])                          # [B,S,H,nope+rope]
    ckr = matmul(h, p["wkv_a"])                         # [B,S,r+rope]
    c = L.rms_norm(p["kv_norm"], ckr[..., :r], cfg.norm_eps)
    kv = L._project(c, p["wkv_b"])                      # [B,S,H,nope+v]
    k_r = L.rope(ckr[..., None, r:], q_pos, cfg.rope_theta)
    q = torch.cat([q[..., :nope], L.rope(q[..., nope:], q_pos,
                                         cfg.rope_theta)], dim=-1)
    k = torch.cat([kv[..., :nope], k_r.expand(B, S, H, rope)], dim=-1)
    v = kv[..., nope:]
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True,
                      scale=1.0 / math.sqrt(nope + rope)).transpose(1, 2)
    wo = p["wo"]
    return matmul(o.flatten(2), wo.reshape(-1, wo.shape[-1]))


def mla_layer(p, cfg, x, q_pos, dense: bool, trace=None):
    """x + MLA(RMSNorm(x)), then + the FFN of RMSNorm of that: the dense
    SwiGLU where ``dense``, else the MoE (``moe.moe_ffn_held``).  Returns
    x."""
    trace = trace or LayerTrace()
    eps = cfg.norm_eps
    with trace.span("lm.mla"):
        y = mla(p["attn"], cfg, L.rms_norm(p["norm1"], x, eps), q_pos)
    x1 = x + y
    h = L.rms_norm(p["norm2"], x1, eps)
    if dense:
        trace.backward_span("lm.mla_bwd", y, x)
        return x1 + L.swiglu(p["ffn"], h)
    with trace.span("lm.moe"):
        y2 = M.moe_ffn_held(p["ffn"], cfg, h, trace)
    trace.backward_span("lm.moe_bwd", y2, x1)
    trace.backward_span("lm.mla_bwd", y, x)
    return x1 + y2
