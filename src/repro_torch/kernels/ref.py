"""Plain PyTorch versions of the port's kernels (the allclose targets).

They mirror ``repro/kernels/ref.py`` and are deliberately naive: the
swap matrix, the per-sample gradients and the attention scores are
materialised in full, and the recurrences walk time step by step.  The
CPU path of ``repro_torch.kernels.ops`` runs them; nothing on the CUDA
path does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None, q_offset: int | None = None):
    """q [B,H,S,hd], k/v [B,KV,T,hd] with KV dividing H (query head h
    reads key head h // (H/KV)) -> [B,H,S,hd] in q's dtype.  Dense masked
    softmax in f32; query i sits at key position i + q_offset, T - S by
    default (queries right-aligned when T > S)."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    G = H // k.shape[1]
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    off = T - S if q_offset is None else q_offset
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi + off
    if window > 0:
        ok &= ki > qi + off - window
    scores = torch.where(ok, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p,
                        v.to(torch.float32)).to(q.dtype)


def attention_bwd_ref(q, k, v, do, *, causal: bool = True, window: int = 0,
                      q_offset: int | None = None):
    """Gradients of ``attention_ref(q, k, v)`` for the output's gradient
    ``do`` -> (dq, dk, dv) in the inputs' dtype: autograd of the dense
    version on the inputs cast to f32, each gradient rounded to the
    inputs' dtype once (the plain version of the attention backward
    kernel; autograd through bf16 leaves would round each query head's
    share of dk and dv before the sum over a key head's group)."""
    with torch.enable_grad():
        leaves = [x.detach().to(torch.float32).requires_grad_(True)
                  for x in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window,
                            q_offset=q_offset)
        grads = torch.autograd.grad(out, leaves, do.to(torch.float32))
    return tuple(g.to(q.dtype) for g in grads)


def wkv_ref(r, k, v, w, u, state=None):
    """RWKV6 naive recurrence. r,k,v,w [B,T,H,hd]; u [H,hd];
    state [B,H,hd,hd] f32 (zeros when None).  Returns
    (y [B,T,H,hd] in r's dtype, final state f32)."""
    B, T, H, hd = r.shape
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.to(torch.float32))
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    uf = u.to(torch.float32)
    ys = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        ys.append(torch.einsum("bhd,bhdv->bhv", rt, S)
                  + torch.einsum("bhd,hd,bhd->bh", rt, uf, kt)[..., None]
                  * vt)
        S = wt[..., None] * S + torch.einsum("bhd,bhv->bhdv", kt, vt)
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(rf)
    return y.to(r.dtype), S


def wkv_bwd_ref(r, k, v, w, u, state, dy, dstate=None):
    """Gradients of the WKV kernel's function (``wkv_ref`` with w clipped
    to [1e-8, 1], as the kernels clip it) for the outputs' gradients dy
    [B,T,H,hd] and dstate [B,H,hd,hd] (zeros when None) -> (dr, dk, dv,
    dw, du, dstate0): the reverse recurrence, step by step, from every
    forward state kept.  With G_T = dstate and G_{t-1} = diag(w_t) G_t
    + r_t dy_t^T:

      dr_t = S_{t-1} dy_t + (u * k_t)(v_t . dy_t)
      dk_t = G_t v_t + (r_t * u)(v_t . dy_t)
      dv_t = G_t^T k_t + (r_t . (u * k_t)) dy_t
      dw_t = rowsum(G_t * S_{t-1}), times jnp.clip's gradient: 1 inside
             (1e-8, 1), 1/2 on a bound, 0 outside
      du   = sum over b, t of r_t * k_t (v_t . dy_t);  dstate0 = G_0.

    In f64 on f64 inputs, else in f32."""
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    B, T, H, hd = r.shape
    rf, kf, vf, wf, dyf = (a.to(dt) for a in (r, k, v, w, dy))
    uf = u.to(dt)
    lo, hi = torch.tensor(1e-8, dtype=torch.float32).item(), 1.0
    wc = wf.clamp(lo, hi)
    clip_grad = torch.where((wf > lo) & (wf < hi), 1.0,
                            torch.where((wf == lo) | (wf == hi), 0.5, 0.0))
    S = state.to(dt)
    states = []                                  # S_{t-1} for every t
    for t in range(T):
        states.append(S)
        S = wc[:, t, ..., None] * S + torch.einsum("bhd,bhv->bhdv",
                                                   kf[:, t], vf[:, t])
    G = (torch.zeros_like(S) if dstate is None else dstate.to(dt))
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in range(T - 1, -1, -1):
        rt, kt, vt, dyt, Sp = rf[:, t], kf[:, t], vf[:, t], dyf[:, t], \
            states[t]
        vdy = (vt * dyt).sum(-1, keepdim=True)           # [B,H,1]
        dr[:, t] = torch.einsum("bhdv,bhv->bhd", Sp, dyt) + uf * kt * vdy
        dk[:, t] = torch.einsum("bhdv,bhv->bhd", G, vt) + rt * uf * vdy
        dv[:, t] = torch.einsum("bhdv,bhd->bhv", G, kt) \
            + (rt * uf * kt).sum(-1, keepdim=True) * dyt
        dw[:, t] = (G * Sp).sum(-1) * clip_grad[:, t]
        du += (rt * kt * vdy).sum(0)
        G = wc[:, t, ..., None] * G + torch.einsum("bhd,bhv->bhdv", rt, dyt)
    return dr, dk, dv, dw, du, G


def rglru_ref(a, b, h0):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t, step by step.
    a, b [B,T,D] f32; h0 [B,D]. Returns (h [B,T,D], h_T)."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return (torch.stack(hs, dim=1) if hs else torch.zeros_like(a)), h


def rglru_bwd_ref(a, h, h0, dh, dh_last):
    """Gradients of ``rglru_ref``'s (h, h_T) for a, h [B,T,D] (h the
    forward's output), h0 [B,D] and the outputs' gradients dh [B,T,D],
    dh_last [B,D] -> (da, db, dh0), f32, the reverse recurrence step by
    step: g_t = dh_t + a_{t+1} g_{t+1} from g_T = dh_last (a_T = 1);
    db_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0), dh0 = a_0 g_0."""
    T = a.shape[1]
    g = dh_last
    da, db = torch.zeros_like(a), torch.zeros_like(a)
    for t in range(T - 1, -1, -1):
        g = dh[:, t] + (a[:, t + 1] * g if t + 1 < T else g)
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t else h0)
    return da, db, (a[:, 0] * g if T else g)


def wemd_swap_ref(p_sum, p_dev, global_dist, class_weights, sizes):
    """Batched dense swap-candidate WEMD matrix (paper Eq. 8 applied to
    Pi \\ {i} u {j} for every pair).  p_sum [B,C], p_dev [B,V,C],
    global_dist/class_weights [B,C], sizes [B] -> [B,V,V]."""
    base = (p_sum[:, None, None, :] - p_dev[:, :, None, :]) \
        + p_dev[:, None, :, :]
    dist = base / sizes[:, None, None, None]
    return torch.sum(torch.abs(dist - global_dist[:, None, None, :])
                     * class_weights[:, None, None, :], dim=-1)


def wemd_add_ref(p_sum, p_dev, global_dist, class_weights, sizes):
    """Batched add-candidate WEMD row (Pi u {v} for every v).
    Same layouts as ``wemd_swap_ref``; returns [B, V]."""
    new = (p_sum[:, None, :] + p_dev) / (sizes[:, None, None] + 1.0)
    return torch.sum(torch.abs(new - global_dist[:, None, :])
                     * class_weights[:, None, :], dim=-1)


def persample_gradnorm_ref(features, logits, labels):
    """sigma-hat (Eq. 10) for a softmax-CE linear head, materialising the
    per-sample gradient tensor [..., B, d, C] (the thing the kernel
    avoids).  features [..., B, d], logits [..., B, C], labels [..., B]
    -> (sigma [...], gi_sq [..., B])."""
    h = features.to(torch.float32)
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    e = p - F.one_hot(labels.long(), logits.shape[-1]).to(torch.float32)
    g = h[..., :, :, None] * e[..., :, None, :]          # [..., B, d, C]
    gbar = g.mean(-3)
    dev = g - gbar[..., None, :, :]
    dev_sq = (dev * dev).sum((-2, -1))
    return torch.sqrt(dev_sq.mean(-1)), (g * g).sum((-2, -1))
