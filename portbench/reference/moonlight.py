"""Moonlight-16B-A3B (DeepSeek-V3's architecture: latent attention, a
leading dense layer, a sigmoid-routed MoE with shared experts) trained by
FedCGD over LM silos, in plain PyTorch: the reference the MoE cell is
held to.

A layer: x += MLA(RMSNorm(x)); x += FFN(RMSNorm(x)), the FFN a SwiGLU in
the first layer and the MoE in the rest.  RMSNorm is x / rms(x) * (1 +
scale), eps 1e-5.  MLA without a query LoRA:

    q = h W_q (heads x [nope | rope]);  [c | k_r] = h W_kva;  c = RMSNorm(c)
    [k_nope | v] = c W_kvb;  RoPE on q_rope and on k_r (shared by heads)
    o = softmax(causal, [q_nope | q_rope] . [k_nope | k_r] / sqrt(nope +
        rope)) v;  out = o W_o

RoPE rotates the halves of the rope channels at theta; HF's DeepSeek-V3
interleaves them (a fixed permutation of W_q's and W_kva's rope columns,
the one departure from the published layer).  The MoE: scores s =
sigmoid(h W_r), the chosen experts the top k of s + b (b the correction
bias; ties at the lower index), their weights the chosen s normalised and
times the routed scaling; y = sum over the chosen experts this device
holds of weight x SwiGLU_e(h), plus the shared SwiGLU, nothing dropped.
The embedding is not scaled; the head reads the final RMSNorm; the loss is
the next-token CE weighted per sequence by its silo's Eq. 2 weight, and
the step SGD in each parameter's dtype.

Everything runs in f32 from the given weights (TF32 off).  Attention runs
in blocks of queries, each block's scores recomputed in the backward.  The
gradient is taken layer by layer as in ``rwkv6.py``.  ``choices``, where
given (one [T, k] tensor of expert ids a MoE layer), replays the
program's routing: the layer routes by them.  Each MoE layer logs its
choice, its own top k and the gap between its own k-th and (k+1)-th
biased score at every token; ``flip_gap`` reads the largest gap at a
token where a given choice differs from the own top k (0 where none
differs): a choice made otherwise at a near-tie is rounding, one made
otherwise by a wide margin is not.  ``fault`` plants a change in the reference put in the
program's place: "drop" (capacity 1.25 with drops, the last tokens
first), "nobias" (the choice over s alone), "noscale" (the weights
without the scaling).  ``rnd`` rounds the operands of every matrix
product (the control).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.rwkv6 import _flat, _mm, _tree

CE_ROWS = 2048
Q_BLOCK = 512
EPS = 1e-5


def _rms(x, p):
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS)
    return x * (1.0 + p["scale"])


def _rope(x, theta):
    """x [B, S, ..., r]: the halves of the last axis rotated by position
    (the sequence axis 1) x theta^(-i / (r/2))."""
    S, half = x.shape[1], x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    shape = (1, S) + (1,) * (x.dim() - 3) + (half,)
    sin, cos = torch.sin(ang).reshape(shape), torch.cos(ang).reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, q0, scale):
    """Causal softmax attention of queries q0.. (q [B,H,b,e]) over keys
    0..q0+b-1 (k [B,H,q0+b,e], v [B,H,q0+b,f])."""
    b = q.shape[2]
    s = torch.einsum("bhqe,bhke->bhqk", q, k) * scale
    qi = torch.arange(q0, q0 + b, device=q.device)[:, None]
    ki = torch.arange(k.shape[2], device=q.device)[None, :]
    s = torch.where(ki <= qi, s, -1e30)
    return torch.einsum("bhqk,bhkf->bhqf", torch.softmax(s, dim=-1), v)


def attention(q, k, v, scale):
    """q, k [B,H,S,e], v [B,H,S,f] -> [B,H,S,f], causal, in query blocks
    of ``Q_BLOCK`` (each recomputed in the backward)."""
    S = q.shape[2]
    outs = []
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, S)
        args = (q[:, :, q0:q1], k[:, :, :q1], v[:, :, :q1], q0, scale)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend_block(*args))
    return torch.cat(outs, dim=2)


def mla(p, h, m, rnd=None):
    B, S, d = h.shape
    H, r = m["num_heads"], m["kv_lora_rank"]
    nope, rope, vd = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    q = _mm(h, p["wq"].reshape(d, -1), rnd).reshape(B, S, H, nope + rope)
    ckr = _mm(h, p["wkv_a"], rnd)
    c = _rms(ckr[..., :r], p["kv_norm"])
    kv = _mm(c, p["wkv_b"].reshape(r, -1), rnd).reshape(B, S, H, nope + vd)
    theta = m["rope_theta"]
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], dim=-1)
    k_r = _rope(ckr[..., None, r:], theta).expand(B, S, H, rope)
    k = torch.cat([kv[..., :nope], k_r], dim=-1)
    o = attention(q.transpose(1, 2), k.transpose(1, 2),
                  kv[..., nope:].transpose(1, 2), 1.0 / math.sqrt(nope + rope))
    return _mm(o.transpose(1, 2).reshape(B, S, H * vd),
               p["wo"].reshape(H * vd, d), rnd)


def swiglu(p, h, rnd=None):
    return _mm(F.silu(_mm(h, p["w_gate"], rnd)) * _mm(h, p["w_up"], rnd),
               p["w_down"], rnd)


def route(p, h, m, choice=None, fault=None, rnd=None):
    """h [T, d] -> (weights [T, k], chosen experts [T, k], log): the
    choice the given one (replayed) or the reference's own; the log is
    (chosen, own top k, own k-th minus (k+1)-th biased score), int16 and
    f32, a row a token."""
    k = m["experts_per_token"]
    s = torch.sigmoid(_mm(h, p["router"], rnd))
    biased = s.detach() if fault == "nobias" else s.detach() + p[
        "router_bias"]
    top = torch.sort(biased, dim=-1, descending=True, stable=True)
    own = top.indices[:, :k]
    choice = own if choice is None else choice.to(s.device).long()
    w = torch.gather(s, 1, choice)
    w = w / (w.sum(-1, keepdim=True) + 1e-20)
    if fault != "noscale":
        w = w * m["routed_scaling"]
    log = (choice.to(torch.int16), own.to(torch.int16),
           top.values[:, k - 1] - top.values[:, k])
    return w, choice, log


def flip_gap(logs, choices) -> float:
    """The largest own k-th / (k+1)-th gap of ``logs`` (a route log a MoE
    layer) at a token whose choice in ``choices`` (one [T, k] a layer)
    differs from the log's own top k; 0 where none differs."""
    gap = 0.0
    for (_, own, kgap), ch in zip(logs, choices):
        ch = ch.to(own.device).long()
        differ = (torch.sort(ch, -1).values
                  != torch.sort(own.long(), -1).values).any(-1)
        if bool(differ.any()):
            gap = max(gap, float(kgap[differ].max()))
    return gap


def moe(p, h, m, choice=None, fault=None, rnd=None):
    """h [B,S,d] -> (y [B,S,d], the layer's chosen experts, route log)."""
    B, S, d = h.shape
    hf = h.reshape(B * S, d)
    T, k, E = B * S, m["experts_per_token"], m["num_experts"]
    w, chosen, log = route(p, hf, m, choice, fault, rnd)
    keep = torch.ones_like(chosen, dtype=torch.bool)
    if fault == "drop":
        # the old path: arrival rank in (token, slot) order within each
        # expert, over capacity dropped
        cap = int(math.ceil(T * k / E * 1.25))
        flat = chosen.reshape(-1)
        onehot = F.one_hot(flat, E)
        rank = (torch.cumsum(onehot, 0) - onehot)[
            torch.arange(T * k, device=flat.device), flat]
        keep = (rank < cap).reshape(T, k)
    y = torch.zeros_like(hf)
    lo = m["expert_lo"]
    for e in range(m["experts_held"]):
        sel = (chosen == lo + e) & keep
        tok = sel.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        we = (w * sel).sum(-1)[tok]
        pe = {n: p[n][e] for n in ("w_gate", "w_up", "w_down")}
        y = y.index_add(0, tok, swiglu(pe, hf[tok], rnd) * we[:, None])
    y = y + swiglu(p["shared"], hf, rnd)
    return y.reshape(B, S, d), chosen, log


def layer(p, x, m, rnd=None, choice=None, fault=None, log=None):
    """One layer; a MoE layer appends its route log to ``log``."""
    x = x + mla(p["attn"], _rms(x, p["norm1"]), m, rnd)
    h = _rms(x, p["norm2"])
    if "router" not in p["ffn"]:
        return x + swiglu(p["ffn"], h, rnd)
    y, _, rlog = moe(p["ffn"], h, m, choice, fault, rnd)
    if log is not None:
        log.append(rlog)
    return x + y


def loss_and_grads(params, m: dict, toks, weights, rnd=None, choices=None,
                   fault=None):
    """(weighted CE, f32 gradient tree like ``params``, routing) of one
    step on token rows ``toks`` [B, S+1] with per-row weights [B];
    routing is the forward's route logs, a MoE layer each."""
    d = m["d_model"]
    blocks = params["blocks"]["layer0"]
    L = m["num_layers"] - 1
    tokens, targets = toks[:, :-1].long(), toks[:, 1:].long()
    B, T = tokens.shape

    def f32(tree, grad):
        return _tree(lambda x: x.detach().float().requires_grad_(grad), tree)

    def layer_params(i, grad):
        return f32(_tree(lambda x: x[i], blocks), grad)

    def run(i, p, x, log=None):
        ch = None if choices is None or i < 0 else choices[i]
        return layer(p, x, m, rnd, ch, fault, log)

    routing = []
    xs = [params["embed"][tokens].float()]
    with torch.no_grad():
        xs.append(run(-1, f32(params["first"], False), xs[-1]))
        for i in range(L):
            xs.append(run(i, layer_params(i, False), xs[-1], routing))
    fn = f32(params["final_norm"], True)
    head = params["lm_head"].detach().float().requires_grad_(True)
    xf = xs.pop().reshape(B * T, d)
    wrow = weights.float()[:, None].expand(B, T).reshape(-1)
    tgt = targets.reshape(-1)
    W = torch.clamp(wrow.sum(), min=1.0)
    gx = torch.empty_like(xf)
    g_fn = _tree(torch.zeros_like, fn)
    g_head = torch.zeros_like(head)
    loss = 0.0
    for a in range(0, B * T, CE_ROWS):
        xc = xf[a:a + CE_ROWS].detach().requires_grad_(True)
        logits = _mm(_rms(xc, fn), head, rnd)
        ce = torch.logsumexp(logits, -1) - logits.gather(
            1, tgt[a:a + CE_ROWS, None])[:, 0]
        s = (ce * wrow[a:a + CE_ROWS]).sum() / W
        gs = torch.autograd.grad(s, [xc, fn["scale"], head])
        gx[a:a + CE_ROWS] = gs[0]
        g_fn["scale"] += gs[1]
        g_head += gs[2]
        loss += float(s.detach())
    g = gx.reshape(B, T, d)
    g_blocks = _tree(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), blocks)

    def back(i, p, g):
        xin = xs.pop().requires_grad_(True)
        leaves = _flat(p)
        out = torch.autograd.grad(run(i, p, xin), [xin] + [x for _, x in
                                                           leaves],
                                  grad_outputs=g, allow_unused=True)
        grads = [torch.zeros_like(x) if gi is None else gi
                 for (_, x), gi in zip(leaves, out[1:])]
        return out[0], [n for n, _ in leaves], grads

    gl = dict(_flat(g_blocks))
    for i in reversed(range(L)):
        g, names, grads = back(i, layer_params(i, True), g)
        for name, gi in zip(names, grads):
            gl[name][i] = gi
    g, names, grads = back(-1, f32(params["first"], True), g)
    g_first = _tree(lambda x: None, params["first"])
    gf = dict(zip(names, grads))
    g_first = _unflat(g_first, gf)
    g_embed = torch.zeros(params["embed"].shape, dtype=torch.float32,
                          device=g.device)
    g_embed.index_add_(0, tokens.reshape(-1), g.reshape(B * T, d))
    return loss, {"embed": g_embed, "first": g_first,
                  "blocks": {"layer0": g_blocks}, "final_norm": g_fn,
                  "lm_head": g_head}, routing


def _unflat(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflat(v, flat, f"{prefix}{k}.") for k, v in tree.items()}
    return flat[prefix[:-1]]
