"""A plain f32 PyTorch reference of moonlight-16b-a3b at test sizes (the
CPU tests' own copy; ``portbench/reference/moonlight.py`` is the
benchmark's, computed in blocks, and ``test_torch_moonlight`` holds the
two to each other).  Imports no JAX and nothing of the port; takes the
port's parameter tree (``models/transformer.init`` of an ``MLAConfig``)
and a dict of the config's fields.

Latent attention: q = h W_q; [c | k_r] = h W_kva; c = RMSNorm(c); [k_nope
| v] = c W_kvb; RoPE (the halves of the rope channels) on q_rope and on
k_r, shared by the heads; causal softmax of q.k / sqrt(nope + rope);
o W_o.  The MoE: s = sigmoid(h W_r) in f32; the top k of s + b (ties at the
lower index); weights the chosen s over their sum times the scaling; the
held experts' SwiGLUs of the tokens chosen for them, and the shared
SwiGLU; nothing dropped.  RMSNorm is x / rms(x) (1 + scale).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms(p, x, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1 + p["scale"])


def rope(x, theta):
    """x [B, S, H, r], positions 0..S-1."""
    S, half = x.shape[1], x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64) / half)
    ang = (torch.arange(S, dtype=torch.float64)[:, None] * inv).float()
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def mla(p, h, c):
    B, S, d = h.shape
    H, r = c["num_heads"], c["kv_lora_rank"]
    nope, rd, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    q = torch.einsum("bsd,dhe->bshe", h, p["wq"])
    ckr = h @ p["wkv_a"]
    lat = rms(p["kv_norm"], ckr[..., :r], c["norm_eps"])
    kv = torch.einsum("bsr,rhe->bshe", lat, p["wkv_b"])
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], -1)
    kr = rope(ckr[:, :, None, r:], c["rope_theta"]).expand(B, S, H, rd)
    k = torch.cat([kv[..., :nope], kr], -1)
    v = kv[..., nope:]
    s = torch.einsum("bqhe,bkhe->bhqk", q, k) / math.sqrt(nope + rd)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    o = torch.einsum("bhqk,bkhe->bqhe", torch.softmax(s, -1), v)
    return torch.einsum("bqhe,hed->bqd", o, p["wo"])


def swiglu(p, h):
    return (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]


def route(p, h, c):
    """h [T, d] -> (weights [T, k], experts [T, k])."""
    s = torch.sigmoid(h @ p["router"])
    order = torch.sort(s.detach() + p["router_bias"], dim=-1,
                       descending=True, stable=True).indices[
        :, :c["experts_per_token"]]
    w = s.gather(1, order)
    return w / w.sum(-1, keepdim=True) * c["routed_scaling"], order


def moe(p, h, c, shared=True):
    """h [B,S,d] -> the held experts' part (and the shared experts')."""
    B, S, d = h.shape
    x = h.reshape(-1, d)
    w, experts = route(p, x, c)
    y = torch.zeros_like(x)
    for i in range(c["experts_held"]):
        hit = experts == c["expert_lo"] + i                  # [T, k]
        rows = hit.any(-1)
        if rows.any():
            wi = (w * hit).sum(-1)[rows]
            pe = {n: p[n][i] for n in ("w_gate", "w_up", "w_down")}
            y = y.index_put((rows.nonzero()[:, 0],),
                            swiglu(pe, x[rows]) * wi[:, None],
                            accumulate=True)
    if shared:
        y = y + swiglu(p["shared"], x)
    return y.reshape(B, S, d)


def layer(p, x, c):
    eps = c["norm_eps"]
    x = x + mla(p["attn"], rms(p["norm1"], x, eps), c)
    h = rms(p["norm2"], x, eps)
    return x + (moe(p["ffn"], h, c) if "router" in p["ffn"]
                else swiglu(p["ffn"], h))


def loss(params, c, tokens, targets, weights):
    """The schedule-weighted next-token CE: rows weighted per sequence."""
    x = params["embed"][tokens]
    x = layer(params["first"], x, c)
    blocks = params["blocks"]["layer0"]
    n = blocks["norm1"]["scale"].shape[0]
    for i in range(n):
        x = layer(_index(blocks, i), x, c)
    logits = rms(params["final_norm"], x, c["norm_eps"]) @ params["lm_head"]
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, targets[..., None])[..., 0]
    wrow = weights[:, None].expand_as(ce)
    return (ce * wrow).sum() / wrow.sum().clamp(min=1.0)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
