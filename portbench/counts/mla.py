"""Frozen counts of moonlight-16b-a3b's step (``configs/moonlight-16b-a3b
.json``'s model block): the forward FLOPs a token, the operations and
bytes of one launch of K4 and K4-bwd at a (q/k, v) head pair, and those
of the held experts' grouped products.  Counted from the shapes as the
benchmark was made; later changes to the program do not move them."""
from __future__ import annotations

from portbench.counts.peaks import BF16_FLOPS, HBM_BW


def forward_flops_per_token(m: dict, seq: int) -> float:
    """Model FLOPs a token of a ``seq``-token sequence, forward: every
    matrix product at 2 a multiply-add; attention over the causal pairs
    exactly ((seq + 1) / 2 keys a query on average, q.k at q/k's head size
    and p.v at v's); the held routed experts at their expected share of
    the token's k (k x held / E); the router, the shared experts, the
    dense layer and the head."""
    d, H, V = m["d_model"], m["num_heads"], m["vocab_size"]
    r, nope = m["kv_lora_rank"], m["qk_nope_head_dim"]
    rope, vd = m["qk_rope_head_dim"], m["v_head_dim"]
    L = m["num_layers"]
    moe_layers = L - m["first_k_dense"]
    proj = 2 * (d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd)
                + H * vd * d)
    attn = (seq + 1) / 2 * 2 * H * (nope + rope + vd)
    swiglu = 6 * d                                  # a unit of width
    held = m["experts_per_token"] * m["experts_held"] / m["num_experts"]
    moe = (swiglu * m["d_ff"] * (held + m["num_shared_experts"])
           + 2 * d * m["num_experts"])
    dense = swiglu * m["dense_ff"] * m["first_k_dense"]
    return L * (proj + attn) + moe_layers * moe + dense + 2 * d * V


def _pairs(S: int, T: int, causal: bool) -> int:
    """Visible (query, key) pairs of one (batch, head), queries
    right-aligned to the keys."""
    if not causal:
        return S * T
    off = T - S
    return sum(min(T, i + off + 1) for i in range(S))


def k4(shapes):
    """K4 on q [B,H,S,hd], k [B,KV,T,hd], mask (causal, window), v [B,KV,
    T,hdv] (bf16; the window not taken): (bytes, operations, seconds),
    operations 2 (hd + hdv) a visible pair (q.k and p.v)."""
    (B, H, S, hd), (_, KV, T, _), mask, (_, _, _, hdv) = shapes
    ops = B * H * _pairs(S, T, bool(mask[0])) * 2 * (hd + hdv)
    nbytes = 2 * (B * H * S * (hd + hdv) + B * KV * T * (hd + hdv))
    return nbytes, ops, max(nbytes / HBM_BW, ops / BF16_FLOPS)


def k4_bwd(shapes):
    """K4-bwd at the same shapes: s and dq at hd, dP and dv at hdv, dk at
    hd, 2 each a visible pair; reads q, k, v, dO, writes dq, dk, dv."""
    (B, H, S, hd), (_, KV, T, _), mask, (_, _, _, hdv) = shapes
    ops = B * H * _pairs(S, T, bool(mask[0])) * 2 * (3 * hd + 2 * hdv)
    nbytes = 2 * (2 * B * H * S * (hd + hdv) + 2 * B * KV * T * (hd + hdv))
    return nbytes, ops, max(nbytes / HBM_BW, ops / BF16_FLOPS)


def experts(m: dict, assignments: int):
    """The held experts' grouped products of one train step with
    ``assignments`` held assignments summed over the MoE layers: each
    assignment's gate, up and down products in the forward, again in the
    remat recompute, and twice in the backward (the input's and the
    weights' gradients): 24 d d_ff operations; bytes the assignments' rows
    (d and d_ff wide, in and out of each product) and each layer's held
    weights read in each pass."""
    d, dff = m["d_model"], m["d_ff"]
    ops = 24 * d * dff * assignments
    per_pass_rows = 2 * assignments * (2 * d + 3 * dff + d)
    layers = m["num_layers"] - m["first_k_dense"]
    weights = 2 * 3 * d * dff * m["experts_held"] * layers
    nbytes = 4 * per_pass_rows + 4 * weights
    return nbytes, ops, max(nbytes / HBM_BW, ops / BF16_FLOPS)


def bound_seconds(fn, shape_counts) -> float:
    """The least time of every launch in ``shape_counts`` ({shapes:
    launches}, the program's ``kernels.common.SHAPES`` of one kernel) at
    a head pair (launches at one head size have no v shape and are not
    counted here)."""
    return sum(n * fn(shapes)[2] for shapes, n in shape_counts.items()
               if len(shapes) == 4)
