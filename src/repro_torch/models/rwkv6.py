"""RWKV6 ("Finch", arXiv:2404.05892) time-mix and channel-mix blocks.

The WKV recurrence has data-dependent per-channel decay:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (S in R^{hd x hd} per head)
    y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t

Prefill and training run it through ``kernels.ops.wkv`` (the
hand-written kernel on a CUDA tensor, the step-by-step plain version on
the CPU) from the layer's carried state; decode takes one step in plain
torch, as the JAX package does.  Under autograd on the card ``ops.wkv``
is ``WKVFn``: the forward kernel saves the state entering each chunk of
16 steps and the backward kernel (K5-bwd) recomputes each chunk from it;
with ``cfg.remat`` the layer runs under the same per-layer
``torch.utils.checkpoint`` as every layer (``transformer.forward_hidden``),
so one layer's chunk states are alive at a time.  On the CPU autograd
runs through the plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, group_norm
from repro_torch.sharding import constrain, matmul

LORA_RANK = 32


def layer_norm_init(dim, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(params, x, eps=1e-5):
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(dtype)


# ---------------------------------------------------------------------------


def time_mix_init(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    r = LORA_RANK
    dev = gen.device
    return {
        "maa_x": torch.zeros((d,), dtype=dtype, device=dev),
        "maa_rkvwg": torch.zeros((5, d), dtype=dtype, device=dev),
        "maa_A": dense_init(gen, (d, 5 * r), scale=0.01, dtype=dtype),
        "maa_B": dense_init(gen, (5, r, d), scale=0.01, dtype=dtype),
        "w_base": torch.full((d,), -1.0, dtype=torch.float32, device=dev),
        "w_A": dense_init(gen, (d, 64), scale=0.01, dtype=dtype),
        "w_B": dense_init(gen, (64, d), scale=0.01, dtype=dtype),
        "u": dense_init(gen, (H, hd), scale=0.1),
        "W_r": dense_init(gen, (d, H * hd), dtype=dtype),
        "W_k": dense_init(gen, (d, H * hd), dtype=dtype),
        "W_v": dense_init(gen, (d, H * hd), dtype=dtype),
        "W_g": dense_init(gen, (d, H * hd), dtype=dtype),
        "W_o": dense_init(gen, (H * hd, d), dtype=dtype),
        "gn_scale": torch.ones((H * hd,), dtype=dtype, device=dev),
        "gn_bias": torch.zeros((H * hd,), dtype=dtype, device=dev),
    }


def channel_mix_init(gen, cfg: ModelConfig, dtype):
    d, dff = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {
        "maa_k": torch.zeros((d,), dtype=dtype, device=dev),
        "maa_r": torch.zeros((d,), dtype=dtype, device=dev),
        "W_k": dense_init(gen, (d, dff), dtype=dtype),
        "W_v": dense_init(gen, (dff, d), dtype=dtype),
        "W_r": dense_init(gen, (d, d), dtype=dtype),
    }


def _token_shift(x, shift_state):
    """x [B,T,d]; shift_state [B,d] (last token of previous segment)."""
    return torch.cat([shift_state[:, None, :], x[:, :-1]], dim=1)


def _ddlerp(p, x, prev):
    """RWKV6 data-dependent token-shift interpolation -> 5 mixed streams."""
    sx = prev - x
    xxx = x + sx * p["maa_x"]
    B, T, d = x.shape
    lora = torch.tanh(matmul(xxx, p["maa_A"])).reshape(B, T, 5, LORA_RANK)
    adj = torch.einsum("btfr,frd->fbtd", lora, p["maa_B"])     # [5,B,T,d]
    mixed = x[None] + sx[None] * (p["maa_rkvwg"][:, None, None, :] + adj)
    return mixed  # [5, B, T, d] -> r,k,v,w,g order


def _decay(p, xw):
    w_raw = p["w_base"] + matmul(
        torch.tanh(matmul(xw, p["w_A"])).to(torch.float32),
        p["w_B"].to(torch.float32))
    return torch.exp(-torch.exp(torch.clamp(w_raw, -8.0, 1.0)))  # in (0,1)


def wkv_step(r, k, v, w, u, state):
    """Single decode step. r,k,v,w [B,H,hd]; state [B,H,hd,hd] f32."""
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, w))
    y = torch.einsum("bhd,bhdv->bhv", r, state) \
        + torch.einsum("bhd,hd,bhd->bh", r, u.to(torch.float32),
                       k)[..., None] * v
    state = w[..., None] * state + torch.einsum("bhd,bhv->bhdv", k, v)
    return y, state


def time_mix(p, cfg: ModelConfig, x, shift_state, wkv_state, ctx=None):
    """x [B,T,d] -> (y, new_shift [B,d], new_wkv_state).  Under ``ctx``,
    r is constrained as the reference's (batch, whole time, heads over
    "model"), and so are k, v and w, which the scan takes at r's
    placements (the reference leaves their layout to the compiler).  The
    token shift and the scan need the whole time axis, so x is gathered
    over the sequence once, here."""
    x = constrain(x, ctx, "batch", None, None)
    B, T, d = x.shape
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    prev = _token_shift(x, shift_state)
    xr, xk, xv, xw, xg = _ddlerp(p, x, prev)

    def heads(a):
        return a.reshape(B, T, H, hd)

    r = heads(matmul(xr, p["W_r"]))
    k = heads(matmul(xk, p["W_k"]))
    v = heads(matmul(xv, p["W_v"]))
    g = F.silu(matmul(xg, p["W_g"]))
    w = heads(_decay(p, xw))
    r, k, v, w = (constrain(a, ctx, "batch", None, "model", None)
                  for a in (r, k, v, w))
    y, wkv_state = ops.wkv(r, k, v, w, p["u"], wkv_state)
    y = y.reshape(B, T, H * hd)
    y = group_norm(y, H, scale=p["gn_scale"], bias=p["gn_bias"])
    y = matmul(y * g, p["W_o"])
    return y, x[:, -1], wkv_state


def time_mix_step(p, cfg: ModelConfig, x, shift_state, wkv_state):
    """Decode: x [B,1,d]."""
    B, _, d = x.shape
    H, hd = cfg.num_heads, cfg.rwkv_head_dim
    prev = shift_state[:, None, :]
    xr, xk, xv, xw, xg = _ddlerp(p, x, prev)

    def sq(a):
        return a.reshape(B, H, hd)

    r, k, v = (sq(matmul(xr, p["W_r"])), sq(matmul(xk, p["W_k"])),
               sq(matmul(xv, p["W_v"])))
    g = F.silu(matmul(xg, p["W_g"]))[:, 0]
    w = sq(_decay(p, xw))
    y, wkv_state = wkv_step(r, k, v, w, p["u"], wkv_state)
    y = y.reshape(B, H * hd).to(x.dtype)
    y = group_norm(y, H, scale=p["gn_scale"], bias=p["gn_bias"])
    y = matmul(y * g, p["W_o"])
    return y[:, None, :], x[:, -1], wkv_state


def channel_mix(p, x, shift_state, ctx=None):
    x = constrain(x, ctx, "batch", None, None)   # the token shift's
    prev = _token_shift(x, shift_state)
    sx = prev - x
    xk = x + sx * p["maa_k"]
    xr = x + sx * p["maa_r"]
    kk = torch.square(torch.relu(matmul(xk, p["W_k"])))
    kk = constrain(kk, ctx, "batch", None, "sp")
    out = torch.sigmoid(matmul(xr, p["W_r"])) * matmul(kk, p["W_v"])
    return out, x[:, -1]
