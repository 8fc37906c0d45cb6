"""RWKV6 "Finch" (arXiv:2404.05892) trained by FedCGD over LM silos, in
plain PyTorch: the reference the LM cell is held to.

A layer: x += TimeMix(LN1(x)); x += ChannelMix(LN2(x)).  The time mix
interpolates each token with its predecessor by data-dependent amounts
(a rank-32 LoRA over five streams), projects r, k, v, g, forms the
per-channel decay w = exp(-exp(w_base + LoRA_64(x_w))) (the exponent
clamped to [-8, 1]), runs the WKV recurrence

    y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t,   S_t = diag(w_t) S_{t-1} + k_t v_t^T

per head, GroupNorms y per head, gates it by silu(g) and projects out.
The channel mix is sigmoid(r) * W_v relu(W_k x_k)^2.  The embedding is
scaled by sqrt(d_model); the head reads the final LayerNorm in f32.
The loss is the next-token cross entropy weighted per sequence by its
silo's Eq. 2 weight (schedule / |schedule| * silos), and the step is SGD
in each parameter's dtype.

Everything runs in f32 from the given weights (TF32 off).  The WKV runs
chunk by chunk (16 steps; within a chunk the decays between two steps
are exp of a difference of cumulative log decays, never above 1).  The
gradient is taken layer by layer: the forward keeps each layer's input,
and the backward recomputes one layer at a time.  ``rnd``, where given,
rounds the operands of every matrix product first (the control).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 16
LORA_RANK = 32
CE_ROWS = 2048


def _mm(a, b, rnd):
    if rnd is None:
        return a @ b
    out = rnd(a) @ rnd(b)
    return rnd.grad(out) if hasattr(rnd, "grad") else out


def _ln(x, p):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps=1e-5)


def _shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def wkv(r, k, v, w, u):
    """r, k, v, w [B, T, H, K] f32, u [H, K] -> y [B, T, H, K], from a
    zero state."""
    B, T, H, K = r.shape
    S = r.new_zeros((B, H, K, K))
    logw = torch.log(w)
    ys = []
    for c0 in range(0, T, CHUNK):
        rc, kc, vc, lw = (a[:, c0:c0 + CHUNK].transpose(1, 2)
                          for a in (r, k, v, logw))          # [B,H,l,K]
        n = rc.shape[2]
        cum = torch.cumsum(lw, dim=2)                        # through t
        prev = cum - lw                                      # through t-1
        y = (rc * torch.exp(prev)) @ S
        below = torch.ones(n, n, dtype=torch.bool,
                           device=r.device).tril(-1)[..., None]
        decay = torch.exp(torch.where(
            below, prev[:, :, :, None, :] - cum[:, :, None, :, :],
            float("-inf")))                                  # [B,H,t,s,K]
        A = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * decay).sum(-1)
        y = y + A @ vc
        y = y + (rc * u[None, :, None, :] * kc).sum(-1, keepdim=True) * vc
        last = cum[:, :, -1:, :]
        S = (torch.exp(last).transpose(-1, -2) * S
             + (kc * torch.exp(last - cum)).transpose(-1, -2) @ vc)
        ys.append(y)
    return torch.cat(ys, dim=2).transpose(1, 2)


def time_mix(p, x, H, K, rnd=None):
    B, T, d = x.shape
    sx = _shift(x) - x
    lora = torch.tanh(_mm(x + sx * p["maa_x"], p["maa_A"], rnd))
    lora = lora.reshape(B, T, 5, LORA_RANK)
    adj = torch.einsum("btfr,frd->fbtd", lora, p["maa_B"])
    xr, xk, xv, xw, xg = x[None] + sx[None] * (
        p["maa_rkvwg"][:, None, None, :] + adj)
    r = _mm(xr, p["W_r"], rnd).reshape(B, T, H, K)
    k = _mm(xk, p["W_k"], rnd).reshape(B, T, H, K)
    v = _mm(xv, p["W_v"], rnd).reshape(B, T, H, K)
    g = F.silu(_mm(xg, p["W_g"], rnd))
    raw = p["w_base"] + _mm(torch.tanh(_mm(xw, p["w_A"], rnd)), p["w_B"],
                            rnd)
    w = torch.exp(-torch.exp(torch.clamp(raw, -8.0, 1.0))).reshape(
        B, T, H, K)
    y = wkv(r, k, v, w, p["u"]).reshape(B, T, H, K)
    y = F.group_norm(y.reshape(B * T, H * K), H, p["gn_scale"],
                     p["gn_bias"], eps=1e-5).reshape(B, T, H * K)
    return _mm(y * g, p["W_o"], rnd)


def channel_mix(p, x, rnd=None):
    sx = _shift(x) - x
    kk = torch.square(torch.relu(_mm(x + sx * p["maa_k"], p["W_k"], rnd)))
    return torch.sigmoid(_mm(x + sx * p["maa_r"], p["W_r"], rnd)) * _mm(
        kk, p["W_v"], rnd)


def layer(p, x, H, K, rnd=None):
    x = x + time_mix(p["tm"], _ln(x, p["ln1"]), H, K, rnd)
    return x + channel_mix(p["cm"], _ln(x, p["ln2"]), rnd)


def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) \
        else fn(t)


def _flat(t, prefix=""):
    if isinstance(t, dict):
        return [x for k, v in t.items() for x in _flat(v, f"{prefix}{k}.")]
    return [(prefix[:-1], t)]


def loss_and_grads(params, model: dict, toks, weights, rnd=None):
    """(weighted CE, f32 gradient tree like ``params``) of one step on
    token rows ``toks`` [B, S+1] with per-row weights [B]."""
    d, H, K = model["d_model"], model["num_heads"], model["rwkv_head_dim"]
    blocks = params["blocks"]["layer0"]
    L = model["num_layers"]
    tokens, targets = toks[:, :-1].long(), toks[:, 1:].long()
    B, T = tokens.shape

    def layer_params(i, grad):
        return _tree(lambda x: x[i].detach().float().requires_grad_(grad),
                     blocks)

    xs = [params["embed"][tokens].float() * math.sqrt(d)]
    with torch.no_grad():
        for i in range(L):
            xs.append(layer(layer_params(i, False), xs[-1], H, K, rnd))
    fn = _tree(lambda x: x.detach().float().requires_grad_(True),
               params["final_norm"])
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
        logits = _mm(_ln(xc, fn), head, rnd)
        ce = torch.logsumexp(logits, -1) - logits.gather(
            1, tgt[a:a + CE_ROWS, None])[:, 0]
        s = (ce * wrow[a:a + CE_ROWS]).sum() / W
        gs = torch.autograd.grad(s, [xc, fn["scale"], fn["bias"], head])
        gx[a:a + CE_ROWS] = gs[0]
        g_fn["scale"] += gs[1]
        g_fn["bias"] += gs[2]
        g_head += gs[3]
        loss += float(s.detach())
    g = gx.reshape(B, T, d)
    g_blocks = _tree(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), blocks)
    for i in reversed(range(L)):
        xin = xs.pop().requires_grad_(True)
        p = layer_params(i, True)
        leaves = _flat(p)
        out = torch.autograd.grad(layer(p, xin, H, K, rnd),
                                  [xin] + [x for _, x in leaves],
                                  grad_outputs=g)
        g = out[0]
        gl = dict(_flat(g_blocks))
        for (name, _), gi in zip(leaves, out[1:]):
            gl[name][i] = gi
    g_embed = torch.zeros(params["embed"].shape, dtype=torch.float32,
                          device=g.device)
    g_embed.index_add_(0, tokens.reshape(-1),
                       g.reshape(B * T, d) * math.sqrt(d))
    return loss, {"embed": g_embed, "blocks": {"layer0": g_blocks},
                  "final_norm": g_fn, "lm_head": g_head}


def sgd(params, grads, eta):
    """x - eta * g, rounded once to each parameter's dtype."""
    if isinstance(params, dict):
        return {k: sgd(params[k], grads[k], eta) for k in params}
    return (params.float() - eta * grads).to(params.dtype)


def silo_weights(mask, per_silo):
    """Each row's Eq. 2 weight: its silo's mask / |schedule| * silos."""
    m = np.asarray(mask, np.float64)
    w = m / max(m.sum(), 1.0) * len(m)
    return np.repeat(w, per_silo)


def _round8(x, dtype, top):
    """x rounded to an fp8 type at a per-tensor scale (its largest
    magnitude at the type's largest, ``top``)."""
    xd = x.detach().float()
    scale = torch.clamp(xd.abs().max(), min=1e-30) / top
    return (xd / scale).to(dtype).float() * scale


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def fp8(x):
    """x rounded to float8 e4m3 (an fp8 product's operands in the
    forward); the gradient passes through.  ``fp8.grad`` marks a
    product's output, so that the backward's products take its gradient
    rounded to e5m2, as fp8 training does."""
    return x + (_round8(x, torch.float8_e4m3fn, 448.0) - x.detach()).detach()


fp8.grad = _GradE5M2.apply
