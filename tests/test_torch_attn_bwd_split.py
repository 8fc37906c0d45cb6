"""The design of the attention backward kernel's bf16 route
(``csrc/flash_attention_bwd.cu``, namespace ``tc``), emulated in torch on
the CPU: its 64-row tiles and the tile ranges it walks, its masks on the
tiles that straddle an edge only, the dq pass's online walk for the row's
log-sum-exp and D, the dk/dv pass's parts of a key head's group with the
f32 partial sums added in order, bf16 operands with f32 sums, and P and
dS split into bf16 hi + lo.  It is held to the plain version
(``kernels/ref.py:attention_bwd_ref``) and to ``jax.vjp`` of the JAX
package's plain attention at the card's bf16 tolerance; one bf16 rounding
of dS instead of the split misses it.  The kernel itself is held to the
plain version on the card in ``tests/test_torch_kernels_cuda.py``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import gqa_parts

BF16_ATTN_TOL = (1e-3, 8e-3)    # one bf16 step, as the forward's check
TILE = 64                       # query rows or keys of a tile (wgmma's M)
NEG = -1e30


def bf16(x):
    return x.to(torch.bfloat16).float()


def times(a, b, split):
    """a @ b with a entering as bf16 operands (hi + lo when ``split``)
    and b bf16-valued, summed in f32."""
    hi = bf16(a)
    out = hi @ b
    return out + bf16(a - hi) @ b if split else out


def visible(key, qp, causal, window):
    ok = torch.ones(torch.broadcast_shapes(key.shape, qp.shape), dtype=bool)
    if causal:
        ok &= key <= qp
    if window > 0:
        ok &= key > qp - window
    return ok


def rows_of(x, r0):
    """Rows r0 .. r0 + 63 of x along axis 2 as a tile, zero past the
    last row (cp.async's zero fill)."""
    x = x[:, :, r0:r0 + TILE]
    gap = TILE - x.shape[2]
    return torch.cat([x, x.new_zeros(*x.shape[:2], gap, *x.shape[3:])],
                     dim=2) if gap else x


def dq_pass(q, k, v, do, causal, window, split_ds=True):
    """The dq kernel: (dq f32 before rounding, lse, D) for q, do [B,H,S,hd]
    and k, v repeated to [B,H,T,hd], all bf16-valued f32."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    off, scale = T - S, 1.0 / math.sqrt(hd)
    scale2 = scale * math.log2(math.e)
    dq = torch.zeros_like(q)
    lse_all, d_all = torch.zeros(B, H, S), torch.zeros(B, H, S)
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, q0 + TILE)
        qp = (rows + off)[:, None]
        qp_first, qp_last = q0 + off, min(q0 + TILE, S) - 1 + off
        k_begin, k_end = 0, T
        if causal:
            k_end = min(T, qp_last + 1)
        if window > 0:
            k_begin = max(0, qp_first - window + 1)
        tiles = range((k_begin // TILE) * TILE, k_end, TILE)
        # every key a real row of the block may see lies in a tile walked
        keys = torch.arange(T)[None, :]
        walked = torch.zeros(T, dtype=bool)
        for kt in tiles:
            walked[kt:kt + TILE] = True
        need = visible(keys, qp, causal, window)[:min(TILE, S - q0)]
        assert not (need & ~walked).any()
        qt, dot = (rows_of(x, q0) for x in (q, do))
        m = torch.full((B, H, TILE), NEG)
        l, dn = torch.zeros(B, H, TILE), torch.zeros(B, H, TILE)

        def tile(kt):
            kk, vv = (rows_of(x, kt) for x in (k, v))
            key = torch.arange(kt, kt + TILE)[None, :]
            ok = (key < T) & visible(key, qp, causal, window)
            edge = (kt + TILE > T or (causal and kt + TILE - 1 > qp_first)
                    or (window > 0 and kt <= qp_last - window))
            if not edge:    # an interior tile needs no mask on a real row
                assert ok[:S - q0].all()
            x = qt @ kk.transpose(-1, -2) * scale2
            if edge:
                x = torch.where(ok, x, NEG)
            return kk, dot @ vv.transpose(-1, -2), x, edge, key
        for kt in tiles:                        # walk 1
            _, dp, x, edge, key = tile(kt)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            if edge:
                p = torch.where(key < T, p, 0.0)
            l = l * alpha + p.sum(-1)
            dn = dn * alpha + (p * dp).sum(-1)
            m = m_new
        lse, d = m + torch.log2(l), dn / l
        acc = torch.zeros(B, H, TILE, hd)
        for kt in tiles:                        # walk 2
            kk, dp, x, _, _ = tile(kt)
            p = torch.exp2(x - lse[..., None])
            acc = acc + times(p * (dp - d[..., None]), kk, split_ds)
        n = min(TILE, S - q0)
        dq[:, :, q0:q0 + n] = acc[:, :, :n] * scale
        lse_all[:, :, q0:q0 + n], d_all[:, :, q0:q0 + n] = lse[..., :n], \
            d[..., :n]
    return dq, lse_all, d_all


def dkv_pass(q, k, v, do, lse, d, causal, window, parts, split_p=True,
             split_ds=True):
    """The dk/dv kernel and, with parts > 1, the GQA sum: (dk, dv) f32
    before rounding, for k, v [B,KV,T,hd]."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    off, scale = T - S, 1.0 / math.sqrt(hd)
    scale2 = scale * math.log2(math.e)
    part = torch.zeros(2, parts, B, KV, T, hd)
    for k0 in range(0, T, TILE):
        key = torch.arange(k0, k0 + TILE)[:, None]
        k_last = min(k0 + TILE, T) - 1
        r_begin = max(0, k0 - off) if causal else 0
        r_end = min(S, k_last + window - off) if window > 0 else S
        qtiles = range((r_begin // TILE) * TILE, r_end, TILE)
        walked = torch.zeros(S, dtype=bool)
        for qt in qtiles:
            walked[qt:qt + TILE] = True
        need = visible(key, torch.arange(S)[None, :] + off, causal,
                       window)[:min(TILE, T - k0)]
        assert not (need & ~walked[None, :]).any()
        kk, vv = (rows_of(x, k0) for x in (k, v))
        for p in range(parts):
            dv_acc = torch.zeros(B, KV, TILE, hd)
            dk_acc = torch.zeros(B, KV, TILE, hd)
            for g in range(p * G // parts, (p + 1) * G // parts):
                heads = torch.arange(KV) * G + g
                for qt in qtiles:
                    qq, dd = (rows_of(x[:, heads], qt) for x in (q, do))
                    rows = torch.arange(qt, qt + TILE)
                    # lse and D of the tile's queries (0 past S), a column
                    # each
                    lse_t, d_t = (rows_of(x[:, heads, :, None], qt)
                                  .transpose(-1, -2) for x in (lse, d))
                    ok = (key < T) & (rows[None, :] < S) & visible(
                        key, rows[None, :] + off, causal, window)
                    edge = (qt + TILE > S or k0 + TILE > T
                            or (causal and k0 + TILE - 1 > qt + off)
                            or (window > 0
                                and k0 <= qt + TILE - 1 + off - window))
                    if not edge:
                        assert ok.all()
                    pt = torch.exp2(kk @ qq.transpose(-1, -2) * scale2
                                    - lse_t)
                    if edge:
                        pt = torch.where(ok, pt, 0.0)
                    dst = pt * (vv @ dd.transpose(-1, -2) - d_t)
                    dv_acc = dv_acc + times(pt, dd, split_p)
                    dk_acc = dk_acc + times(dst, qq, split_ds)
            n = min(TILE, T - k0)
            part[0, p, :, :, k0:k0 + n] = dk_acc[:, :, :n]
            part[1, p, :, :, k0:k0 + n] = dv_acc[:, :, :n]
    total = part[:, 0]
    for p in range(1, parts):         # the parts in order
        total = total + part[:, p]
    return total[0] * scale, total[1]


def emulate(q, k, v, do, causal, window, parts=1, split_p=True,
            split_ds=True):
    """The bf16 route's (dq, dk, dv), rounded to bf16 once."""
    G = q.shape[1] // k.shape[1]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    dq, lse, d = dq_pass(qf, kf.repeat_interleave(G, 1),
                         vf.repeat_interleave(G, 1), dof, causal, window,
                         split_ds)
    dk, dv = dkv_pass(qf, kf, vf, dof, lse, d, causal, window, parts,
                      split_p, split_ds)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def worst_ratio(got, want):
    """max |got - want| / (atol + rtol |want|): at most 1 within the
    tolerance."""
    atol, rtol = BF16_ATTN_TOL
    return float(((got.float() - want.float()).abs()
                  / (atol + rtol * want.float().abs())).max())


def inputs(B, H, KV, S, T, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((B, H, S, hd), (B, KV, T, hd), (B, KV, T, hd),
                          (B, H, S, hd))]


def jax_grads(q, k, v, do, causal, window):
    """jax.vjp of the JAX package's plain attention over the key heads
    repeated to the query heads, in f32, rounded to bf16 once."""
    G = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return jref.attention_ref(q, jnp.repeat(k, G, axis=1),
                                  jnp.repeat(v, G, axis=1), causal=causal,
                                  window=window)
    args = [jnp.asarray(x.float().numpy()) for x in (q, k, v, do)]
    _, vjp = jax.vjp(f, *args[:3])
    return [torch.from_numpy(np.array(g)).to(torch.bfloat16)
            for g in vjp(args[3])]


# recurrentgemma-2b's train step, cut to one sequence: ten query heads on
# one key head at hd 256, causal, S = T = 256; its parts of the group
@pytest.mark.parametrize("parts", [1, 2, 5, 10])
def test_split_design_meets_bf16_tolerance_at_train_shape(parts):
    q, k, v, do = inputs(1, 10, 1, 256, 256, 256, seed=0)
    got = emulate(q, k, v, do, True, 0, parts=parts)
    want = tref.attention_bwd_ref(q, k, v, do, causal=True)
    for name, g, w, j in zip(("dq", "dk", "dv"), got, want,
                             jax_grads(q, k, v, do, True, 0)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert worst_ratio(g, w) <= 1, name
        assert worst_ratio(g, j) <= 1, name


def test_one_rounding_of_ds_misses_the_tolerance():
    """The reason the kernel splits dS: with one bf16 rounding of dS (P
    still split) dq and dk stray past the check's tolerance, with the
    same seed and shape as the split design above."""
    q, k, v, do = inputs(1, 10, 1, 256, 256, 256, seed=0)
    want = tref.attention_bwd_ref(q, k, v, do, causal=True)
    got = emulate(q, k, v, do, True, 0, split_ds=False)
    ratios = [worst_ratio(g, w) for g, w in zip(got, want)]
    assert ratios[0] > 1 and ratios[1] > 1, ratios
    assert ratios[2] <= 1, ratios       # dv does not use dS


# B, H, KV, S, T, hd, causal, window: GQA groups of 1, 2 and 10; head
# sizes 32, 64, 128; S off the 64-row tiles; T > S (right-aligned
# queries); a window that cuts inside a tile; no mask
@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window", [
    (1, 2, 2, 100, 100, 32, True, 0),
    (2, 2, 1, 130, 130, 64, True, 40),
    (1, 4, 2, 70, 200, 128, True, 0),
    (1, 2, 2, 80, 80, 64, False, 0),
    (1, 10, 1, 150, 150, 256, True, 100),
    (1, 4, 2, 96, 160, 32, False, 50),
])
def test_split_design_edges(B, H, KV, S, T, hd, causal, window):
    q, k, v, do = inputs(B, H, KV, S, T, hd, seed=S + T + hd)
    want = tref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    G = H // KV
    for parts in sorted({1, G}):
        got = emulate(q, k, v, do, causal, window, parts=parts)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert worst_ratio(g, w) <= 1, (name, parts)


def test_gqa_parts_fills_the_card():
    """The fewest parts of the group that give two blocks an SM: the
    train step (4 key tiles x 16 sequences, ten heads on one key head)
    takes 5 on 132 SMs, the 4 x 3072-token prefill's shape 2; a group of
    one is one part; a grid too small for any part count takes the whole
    group."""
    assert gqa_parts(16, 1, 256, 10, 132) == 5
    assert gqa_parts(4, 1, 3072, 10, 132) == 2
    assert gqa_parts(16, 16, 256, 1, 132) == 1
    assert gqa_parts(1, 1, 64, 10, 132) == 10
    assert gqa_parts(1, 2, 300, 2, 132) == 2


class OnCard(torch.Tensor):
    """A CPU tensor that calls itself a CUDA tensor on device 0, so that
    a wrapper's validation runs here; it cannot launch."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def test_bf16_wrappers_refuse_unaligned_input_before_launch(monkeypatch):
    """The bf16 route has no fallback: data off 16-byte alignment or a
    stride off a multiple of 8 elements raises ValueError before the
    kernel is built or launched, in the forward and the backward; so
    does a part count that does not divide the group, or parts on the
    f32 route.  Aligned input reaches the launcher."""
    from repro_torch.kernels import flash_attention as K

    def no_launch():
        raise AssertionError("the kernel was reached")
    monkeypatch.setattr(K, "_launcher", no_launch)
    monkeypatch.setattr(K, "_bwd_launcher", no_launch)
    flat = torch.zeros(4 * 64 * 64 + 8, dtype=torch.bfloat16)
    good = flat[:4 * 64 * 64].view(1, 4, 64, 64).as_subclass(OnCard)
    off8 = flat[4:4 + 4 * 64 * 64].view(1, 4, 64, 64).as_subclass(OnCard)
    rows = torch.zeros(1, 4, 64, 68, dtype=torch.bfloat16)[..., :64] \
        .as_subclass(OnCard)                  # row stride 68
    kv = good[:, :2]
    for q in (off8, rows):
        with pytest.raises(ValueError, match="16-byte"):
            K.flash_attention_cuda(q, kv, kv)
        with pytest.raises(ValueError, match="16-byte"):
            K.flash_attention_bwd_cuda(q, kv, kv, good, parts=1)
        with pytest.raises(ValueError, match="16-byte"):
            K.flash_attention_bwd_cuda(good, kv, kv, q, parts=1)
    with pytest.raises(ValueError, match="parts"):
        K.flash_attention_bwd_cuda(good, kv, kv, good, parts=3)
    f32 = good.float().as_subclass(OnCard)
    with pytest.raises(ValueError, match="parts"):
        K.flash_attention_bwd_cuda(f32, f32[:, :2], f32[:, :2], f32,
                                   parts=2)
    with pytest.raises(AssertionError, match="reached"):
        K.flash_attention_cuda(good, kv, kv)
    for parts in (1, 2):
        with pytest.raises(AssertionError, match="reached"):
            K.flash_attention_bwd_cuda(good, kv, kv, good, parts=parts)
