"""Random weights of moonlight-16b-a3b from the run's seed, drawn on the
device in a few large calls, in the dtype they are trained in, in the
port's parameter layout (``models/transformer.init`` for an
``MLAConfig``: the dense layer under ``first``, the 26 MoE layers stacked
[L, ...] under ``blocks.layer0``); the same tensors go to the port and to
the reference.

Every projection is N(0, 1/fan_in), and the matrices that end a residual
branch (W_o and every SwiGLU's W_down: the dense layer's, each held
expert's and the shared experts') are smaller by sqrt(2 x 27) more, as
``weights.rwkv6``'s (GPT-2's scale for its residual outputs: at full
scale 27 layers multiply the backward's gain).  The router is f32 N(0,
1/d); the correction bias f32 N(0, ``BIAS_STD``^2), a trained model's
being unknown here; the embedding N(0, 0.02^2); every RMSNorm's scale 0
(a weight of one).
"""
from __future__ import annotations

import torch

from portbench.traffic.weights import _draw

BIAS_STD = 0.05


def moonlight(gen, m: dict, device):
    dt = getattr(torch, m["param_dtype"])
    d, V, H = m["d_model"], m["vocab_size"], m["num_heads"]
    L = m["num_layers"] - 1                   # the MoE layers
    r, nope = m["kv_lora_rank"], m["qk_nope_head_dim"]
    rope, vd = m["qk_rope_head_dim"], m["v_head_dim"]
    E, nh, dff = m["num_experts"], m["experts_held"], m["d_ff"]
    sh, dense = m["num_shared_experts"] * dff, m["dense_ff"]
    out = (2 * m["num_layers"]) ** -0.5

    def attn(pre, lead):
        return [(f"{pre}wq", lead + (d, H, nope + rope), d ** -0.5),
                (f"{pre}wkv_a", lead + (d, r + rope), d ** -0.5),
                (f"{pre}wkv_b", lead + (r, H, nope + vd), r ** -0.5),
                (f"{pre}wo", lead + (H, vd, d), out * (H * vd) ** -0.5)]

    def swiglu(pre, lead, w):
        return [(f"{pre}w_gate", lead + (d, w), d ** -0.5),
                (f"{pre}w_up", lead + (d, w), d ** -0.5),
                (f"{pre}w_down", lead + (w, d), out * w ** -0.5)]

    specs = ([("embed", (V, d), 0.02)] + attn("first.attn.", ())
             + swiglu("first.ffn.", (), dense) + attn("attn.", (L,))
             + swiglu("ffn.", (L, nh), dff) + swiglu("shared.", (L,), sh)
             + [("lm_head", (d, V), d ** -0.5)])
    flat = _draw(gen, device, specs, dt)
    f32 = _draw(gen, device, [("router", (L, d, E), d ** -0.5),
                              ("bias", (L, E), BIAS_STD)], torch.float32)

    def norm(*shape):
        return {"scale": torch.zeros(shape, dtype=dt, device=device)}

    def pick(pre):
        return {k[len(pre):]: v for k, v in flat.items()
                if k.startswith(pre) and "." not in k[len(pre):]}

    first = {"norm1": norm(d), "attn": {**pick("first.attn."),
                                        "kv_norm": norm(r)},
             "norm2": norm(d), "ffn": pick("first.ffn.")}
    layer = {"norm1": norm(L, d), "attn": {**pick("attn."),
                                           "kv_norm": norm(L, r)},
             "norm2": norm(L, d),
             "ffn": {"router": f32["router"], "router_bias": f32["bias"],
                     **pick("ffn."), "shared": pick("shared.")}}
    return {"embed": flat["embed"], "first": first,
            "blocks": {"layer0": layer}, "final_norm": norm(d),
            "lm_head": flat["lm_head"]}
