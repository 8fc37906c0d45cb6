"""Random weights from the run's seed, drawn on the device in a few large
calls, in the dtype they are trained in, in the port's parameter layout
(the same tensors go to the port and to the reference)."""
from __future__ import annotations

import math

import torch


def _draw(gen, device, specs, dtype):
    """{key: N(0, std^2) of shape} from one draw of every element."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, i = {}, 0
    for key, shape, std in specs:
        n = math.prod(shape)
        out[key] = buf[i:i + n].view(shape).mul_(std)
        i += n
    return out


def resnet18gn(gen, classes: int, channels: int, device):
    """He-normal convolutions, the head at std 0.05, GroupNorm scales one
    and biases zero: the flat dict ``models/cnn.py`` of the port takes."""
    from portbench.reference.resnet18gn import blocks

    def he(k, cin):
        return math.sqrt(2.0 / (k * k * cin))

    specs = [("stem", (64, channels, 3, 3), he(3, channels))]
    norms = {"gn": 64}
    for p, cin, cout, _, proj in blocks():
        specs += [(f"{p}.conv1", (cout, cin, 3, 3), he(3, cin)),
                  (f"{p}.conv2", (cout, cout, 3, 3), he(3, cout))]
        norms[f"{p}.gn1"] = norms[f"{p}.gn2"] = cout
        if proj:
            specs.append((f"{p}.proj", (cout, cin, 1, 1), he(1, cin)))
            norms[f"{p}.gnp"] = cout
    specs.append(("fc", (512, classes), 0.05))
    params = _draw(gen, device, specs, torch.float32)
    for key, c in norms.items():
        params[f"{key}_s"] = torch.ones(c, device=device)
        params[f"{key}_b"] = torch.zeros(c, device=device)
    params["fc_b"] = torch.zeros(classes, device=device)
    return params


def rwkv6(gen, cfg, device):
    """The port's RWKV6 tree (``models/transformer.init``'s layout: the
    layers' leaves stacked [L, ...] under ``blocks.layer0``), every
    projection N(0, 1/fan_in) but the two that end a residual branch (the
    time mix's ``W_o`` and the channel mix's ``W_v``), which are scaled
    down by sqrt(2 L) more, the embedding N(0, 0.02^2), the token-shift
    mixes U(0, 1) and the decay bases U(-6, -0.5) (the paper's ranges),
    u N(0, 0.1^2) and the norms at one and zero.  ``w_base`` and ``u``
    are f32, as the port keeps them; the rest in ``cfg.param_dtype``.

    RWKV initialises those two projections to zero, so that the residual
    stream starts near the identity; at full scale instead, 32 layers
    multiply the backward's gain until the gradient is 10^3 times its
    2-layer size and rounding alone moves it by tens of percent (f32
    against f32), so no reference could hold the step to anything.  A
    sqrt(2 L) smaller scale (GPT-2's for its residual outputs) keeps every
    gradient nonzero and the step well conditioned."""
    dt = getattr(torch, cfg.param_dtype)
    L, d, dff, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, hd, r = cfg.num_heads, cfg.rwkv_head_dim, 32
    A = H * hd
    specs = [("tm.maa_A", (L, d, 5 * r), 0.01),
             ("tm.maa_B", (L, 5, r, d), 0.01),
             ("tm.w_A", (L, d, 64), 0.01), ("tm.w_B", (L, 64, d), 0.01)]
    specs += [(f"tm.W_{n}", (L, d, A), d ** -0.5) for n in "rkvg"]
    out = (2 * L) ** -0.5
    specs += [("tm.W_o", (L, A, d), out * A ** -0.5),
              ("cm.W_k", (L, d, dff), d ** -0.5),
              ("cm.W_v", (L, dff, d), out * dff ** -0.5),
              ("cm.W_r", (L, d, d), d ** -0.5),
              ("embed", (V, d), 0.02), ("lm_head", (d, V), d ** -0.5)]
    flat = _draw(gen, device, specs, dt)
    mix = torch.rand((L, 8, d), generator=gen, device=device).to(dt)
    u = torch.randn((L, H, hd), generator=gen, device=device) * 0.1
    w_base = -6.0 + 5.5 * torch.rand((L, d), generator=gen, device=device)

    def ln(*lead):
        return {"scale": torch.ones(lead + (d,), dtype=dt, device=device),
                "bias": torch.zeros(lead + (d,), dtype=dt, device=device)}

    tm = {k[3:]: v for k, v in flat.items() if k.startswith("tm.")}
    tm.update(maa_x=mix[:, 0].contiguous(),
              maa_rkvwg=mix[:, 1:6].contiguous(), w_base=w_base, u=u,
              gn_scale=torch.ones((L, A), dtype=dt, device=device),
              gn_bias=torch.zeros((L, A), dtype=dt, device=device))
    cm = {k[3:]: v for k, v in flat.items() if k.startswith("cm.")}
    cm.update(maa_k=mix[:, 6].contiguous(), maa_r=mix[:, 7].contiguous())
    layer = {"ln1": ln(L), "tm": tm, "ln2": ln(L), "cm": cm}
    return {"embed": flat["embed"], "blocks": {"layer0": layer},
            "final_norm": ln(), "lm_head": flat["lm_head"]}
