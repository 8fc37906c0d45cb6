"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

    i_t = sigmoid(W_i x_t + b_i)                      (input gate)
    r_t = sigmoid(W_r x_t + b_r)                      (recurrence gate)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the diagonal recurrence through ``kernels.ops.rglru`` (the
hand-written kernel on a CUDA tensor, its plain version on the CPU);
decode takes one step in plain torch, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, gelu
from repro_torch.sharding import constrain, matmul

RG_LRU_C = 8.0


def recurrent_block_init(gen, cfg: ModelConfig, dtype):
    d = cfg.d_model
    lru = cfg.lru_width or d
    W = cfg.conv1d_width
    dev = gen.device
    # Lambda init so that a^c in [0.9, 0.999] (Griffin appendix)
    u = torch.rand((lru,), generator=gen, device=dev) \
        * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
    lam = torch.log(torch.expm1(-torch.log(u) / RG_LRU_C))   # softplus^-1
    return {
        "w_x": dense_init(gen, (d, lru), dtype=dtype),
        "w_gate": dense_init(gen, (d, lru), dtype=dtype),
        "conv_kernel": dense_init(gen, (W, lru), scale=0.1, dtype=dtype),
        "conv_bias": torch.zeros((lru,), dtype=dtype, device=dev),
        "W_i": dense_init(gen, (lru, lru), dtype=dtype),
        "b_i": torch.zeros((lru,), dtype=torch.float32, device=dev),
        "W_r": dense_init(gen, (lru, lru), dtype=dtype),
        "b_r": torch.zeros((lru,), dtype=torch.float32, device=dev),
        "Lambda": lam,
        "w_out": dense_init(gen, (lru, d), dtype=dtype),
    }


def _causal_conv1d(kernel, bias, x, conv_state):
    """Depthwise causal conv. x [B,T,lru]; conv_state [B,W-1,lru] history."""
    W = kernel.shape[0]
    xx = torch.cat([conv_state.to(x.dtype), x], dim=1)
    L = xx.shape[1]
    out = sum(xx[:, W - 1 - i: L - i] * kernel[W - 1 - i] for i in range(W))
    new_state = xx[:, -(W - 1):] if W > 1 else conv_state
    return out + bias, new_state


def _rg_lru_coeffs(p, x):
    """x [B,T,lru] -> (a, b) with h_t = a_t h_{t-1} + b_t, all f32."""
    xf = x.to(torch.float32)
    i = torch.sigmoid(matmul(xf, p["W_i"].to(torch.float32)) + p["b_i"])
    r = torch.sigmoid(matmul(xf, p["W_r"].to(torch.float32)) + p["b_r"])
    log_a = -RG_LRU_C * F.softplus(p["Lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) \
        * (i * xf)
    return a, b


def rg_lru_scan(p, x, h0, ctx=None):
    """The recurrence over all of x [B,T,lru] from h0 [B,lru] f32 ->
    (h in x's dtype, h_T f32).  Under ``ctx`` the coefficients keep x's
    placements (batch, whole time, channels over "sp") for the scan."""
    a, b = _rg_lru_coeffs(p, x)
    a = constrain(a, ctx, "batch", None, "sp")
    b = constrain(b, ctx, "batch", None, "sp")
    h, h_last = ops.rglru(a, b, h0)
    return h.to(x.dtype), h_last


def rg_lru_step(p, x, h0):
    """x [B,1,lru]; h0 [B,lru] f32."""
    a, b = _rg_lru_coeffs(p, x)
    h = a[:, 0] * h0 + b[:, 0]
    return h[:, None, :].to(x.dtype), h


def recurrent_block(p, cfg: ModelConfig, x, state, decode: bool = False,
                    ctx=None):
    """Griffin recurrent block. x [B,T,d];
    state = {'h': [B,lru] f32, 'conv': [B,W-1,lru] f32}."""
    # the scan needs the whole time axis: the block's input is gathered
    # over the sequence once, here
    x = constrain(x, ctx, "batch", None, None)
    gate = gelu(matmul(x, p["w_gate"]))
    xb = matmul(x, p["w_x"])
    xb = constrain(xb, ctx, "batch", None, "sp")
    xb, conv_state = _causal_conv1d(p["conv_kernel"], p["conv_bias"], xb,
                                    state["conv"])
    if decode:
        h, h_last = rg_lru_step(p, xb, state["h"])
    else:
        h, h_last = rg_lru_scan(p, xb, state["h"], ctx)
    out = matmul(h * gate, p["w_out"])
    return out, {"h": h_last, "conv": conv_state.to(torch.float32)}


def init_recurrent_state(cfg: ModelConfig, batch: int, device):
    lru = cfg.lru_width or cfg.d_model
    W = cfg.conv1d_width
    return {"h": torch.zeros((batch, lru), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, W - 1, lru), dtype=torch.float32,
                                device=device)}
