"""The plain versions of the LM kernels (what the port's CPU path runs)
against ``repro.kernels.ref`` and the interpret-mode Pallas kernels, at
``tests/test_kernels.py``'s shapes and tolerances.  The hand-written
kernels are held against these plain versions on the card in
``tests/test_torch_kernels_cuda.py``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention
from repro.kernels.rglru_scan import rglru_pallas
from repro.kernels.rwkv_scan import wkv_pallas
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

ATTN_SHAPES = [(2, 3, 128, 128, 64), (1, 2, 256, 256, 64),
               (2, 2, 100, 100, 32), (1, 2, 64, 192, 64),
               (1, 1, 128, 128, 128), (1, 1, 257, 257, 64)]
WKV_SHAPES = [(2, 48, 3, 32), (1, 16, 2, 64), (2, 100, 2, 16), (1, 64, 1, 64)]
RGLRU_SHAPES = [(2, 300, 64), (1, 128, 512), (3, 37, 100), (1, 1024, 256)]


def randn(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("B,H,S,T,hd", ATTN_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_attention_plain_matches_reference(B, H, S, T, hd, causal, window):
    rng = np.random.default_rng(S * 7 + T + hd + window)
    q, k, v = (randn(rng, (B, H, n, hd)) for n in (S, T, T))
    got = tref.attention_ref(t(q), t(k), t(v), causal=causal,
                             window=window).numpy()
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    pallas = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got, pallas, atol=3e-5, rtol=1e-4)
    # the CPU route of the dispatcher is the plain version
    np.testing.assert_array_equal(
        ops.attention(t(q), t(k), t(v), causal=causal, window=window).numpy(),
        got)


def test_attention_plain_bf16_and_shared_kv_heads():
    """bf16 in, bf16 out (atol 3e-2, test_flash_attention_dtypes); a
    single key head serves every query head as ``_expand_kv`` would."""
    rng = np.random.default_rng(1)
    q, k, v = (randn(rng, (1, 2, 128, 64)) for _ in range(3))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tref.attention_ref(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    want = flash_attention(*jb, causal=True, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)
    kv1 = [x[:, :1] for x in (k, v)]
    got = tref.attention_ref(t(q), *(t(x) for x in kv1), causal=True,
                             window=16)
    want = jref.attention_ref(jnp.asarray(q),
                              *(jnp.asarray(np.repeat(x, 2, axis=1))
                                for x in kv1), causal=True, window=16)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


# chip_smoke.py's tolerance for the bf16 kernel against the plain version
BF16_ATTN_TOL = dict(atol=1e-3, rtol=8e-3)


def tensor_core_attention(q, k, v, *, causal, window, split=True, bm=128,
                          bn=64):
    """The bf16 route of ``csrc/flash_attention.cu`` in plain torch, in
    f32: blocks of ``bm`` query rows visit only the ``bn``-key tiles that
    the causal and window edges let through, with an online softmax in
    base 2, and P V is two bf16 products (hi = bf16(p), lo = bf16(p -
    hi)) summed in f32, or one (``split=False``).  q.k of bf16 inputs is
    exact per product, as on the tensor cores.  Returns (out, visited
    tiles, tiles a dense loop would visit)."""
    B, H, S, hd = q.shape
    T = k.shape[2]
    G = H // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(G, dim=1) for x in (k, v))
    pad = (-T) % bn                                 # zero rows, as cp.async fills
    kf, vf = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (kf, vf))
    scale2 = math.log2(math.e) / math.sqrt(hd)
    off = T - S
    ok_all = torch.ones(S, T + pad, dtype=torch.bool)
    qi = torch.arange(S)[:, None] + off
    ki = torch.arange(T + pad)[None, :]
    ok_all &= ki < T
    if causal:
        ok_all &= ki <= qi
    if window > 0:
        ok_all &= ki > qi - window
    out = torch.empty(B, H, S, hd)
    visited = 0
    for q0 in range(0, S, bm):
        q1 = min(q0 + bm, S)
        qp_first, qp_last = q0 + off, q1 - 1 + off
        k_begin, k_end = 0, T
        if causal:
            k_end = min(T, qp_last + 1)
        if window > 0:
            k_begin = max(0, qp_first - window + 1)
        if causal and qp_first < 0:
            k_begin, k_end = 0, T
        tiles = range((k_begin // bn) * bn, k_end, bn)
        seen = torch.zeros(T + pad, dtype=torch.bool)
        m = torch.full((B, H, q1 - q0), -1e30)
        l = torch.zeros(B, H, q1 - q0)
        acc = torch.zeros(B, H, q1 - q0, hd)
        for kt in tiles:
            visited += 1
            seen[kt:kt + bn] = True
            ok = ok_all[q0:q1, kt:kt + bn]
            s = torch.einsum("bhsd,bhtd->bhst", qf[:, :, q0:q1],
                             kf[:, :, kt:kt + bn]) * scale2
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            p = torch.where(ki[:, kt:kt + bn] < T, p, 0.0)
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vf[:, :, kt:kt + bn]
            if split:
                pv = pv + (p - hi).to(torch.bfloat16).float() \
                    @ vf[:, :, kt:kt + bn]
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + pv
            m = m_new
        # the tiles left out hold no key that a row of the block may see
        assert not (ok_all[q0:q1] & ~seen).any()
        out[:, :, q0:q1] = acc / l.clamp_min(1e-30)[..., None]
    return out, visited, -(-S // bm) * -(-T // bn)


# B, H, KV, S, T, hd, causal, window: the window cuts inside a tile; T > S
# (right-aligned queries); T < S (causal rows that see no key); KV groups
@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window", [
    (1, 4, 2, 300, 300, 64, True, 100),
    (1, 2, 1, 100, 300, 32, True, 0),
    (1, 2, 2, 300, 64, 64, True, 0),
    (2, 2, 2, 200, 200, 128, False, 0),
    (1, 2, 1, 257, 257, 256, True, 70),
    (1, 2, 2, 300, 300, 128, True, 0),
])
def test_tensor_core_attention_numerics(B, H, KV, S, T, hd, causal, window):
    """The design of the kernel's bf16 route (tile loop, visited-tile cut,
    all-masked rows, P split into bf16 hi + lo) held to the plain version
    and to the interpret-mode Pallas kernel at the card's bf16 tolerance;
    before the output's rounding, the split keeps the f32 function to
    1e-4 where one bf16 rounding of P does not."""
    rng = np.random.default_rng(S + T + hd + window)
    q = t(randn(rng, (B, H, S, hd))).to(torch.bfloat16)
    k, v = (t(randn(rng, (B, KV, T, hd))).to(torch.bfloat16)
            for _ in range(2))
    out, visited, dense = tensor_core_attention(q, k, v, causal=causal,
                                                window=window)
    want = tref.attention_ref(q.float(), k.float(), v.float(),
                              causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    single, _, _ = tensor_core_attention(q, k, v, causal=causal,
                                         window=window, split=False)
    assert (single - want).abs().max() > 1e-4
    if window or (causal and S == T):       # the edges cut the loop
        assert visited < dense
    got = out.to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(
        got, tref.attention_ref(q, k, v, causal=causal,
                                window=window).float().numpy(),
        **BF16_ATTN_TOL)
    G = H // KV
    pallas = flash_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16)
          for x in (q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1))),
        causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               **BF16_ATTN_TOL)


def wkv_inputs(rng, B, T, H, hd):
    r = randn(rng, (B, T, H, hd))
    k = randn(rng, (B, T, H, hd), scale=0.3)
    v = randn(rng, (B, T, H, hd))
    w = (1 / (1 + np.exp(-rng.normal(size=(B, T, H, hd)) * 2)) * 0.6
         + 0.39).astype(np.float32)
    u = randn(rng, (H, hd), scale=0.1)
    return r, k, v, w, u


@pytest.mark.parametrize("B,T,H,hd", WKV_SHAPES)
def test_wkv_plain_matches_reference(B, T, H, hd):
    rng = np.random.default_rng(T + hd)
    args = wkv_inputs(rng, B, T, H, hd)
    y, s = tref.wkv_ref(*(t(a) for a in args))
    yr, sr = jref.wkv_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), yr, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), sr, atol=2e-3, rtol=1e-3)
    yp, sp = wkv_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(y.numpy(), yp, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), sp, atol=2e-3, rtol=1e-3)


def test_wkv_plain_from_a_state_matches_model_path():
    """The port's ``ops.wkv`` takes an initial state, as the JAX model's
    ``wkv_chunked`` does (the Pallas kernel starts from zeros)."""
    rng = np.random.default_rng(5)
    B, T, H, hd = 2, 40, 2, 32
    r, k, v, w, u = wkv_inputs(rng, B, T, H, hd)
    state = randn(rng, (B, H, hd, hd), scale=0.5)
    y, s = ops.wkv(*(t(a) for a in (r, k, v, w, u, state)))
    yr, sr = wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u, state)))
    np.testing.assert_allclose(y.numpy(), yr, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), sr, atol=2e-3, rtol=1e-3)
    yb, _ = ops.wkv(*(t(a).to(torch.bfloat16) for a in (r, k, v)),
                    *(t(a) for a in (w, u, state)))
    assert yb.dtype == torch.bfloat16          # y in r's dtype


def test_wkv_plain_extreme_decay():
    rng = np.random.default_rng(7)
    B, T, H, hd = 1, 32, 1, 16
    r, k, v = (randn(rng, (B, T, H, hd)) for _ in range(3))
    w = np.full((B, T, H, hd), 1e-4, np.float32)
    u = randn(rng, (H, hd))
    y, _ = tref.wkv_ref(*(t(a) for a in (r, k, v, w, u)))
    assert np.isfinite(y.numpy()).all()
    yp, _ = wkv_pallas(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                       interpret=True)
    np.testing.assert_allclose(y.numpy(), yp, atol=1e-3, rtol=1e-3)


def chunked_wkv(r, k, v, w, u, state, chunk=16, split=False):
    """The design of ``csrc/wkv.cu`` in plain torch, in f32: chunks of 16
    steps; per channel the base-2 log decays lc[t] = sum over u <= t of
    log2(clip(w_u, 1e-8, 1)), with lc[t - 1] (0 at the chunk's first step)
    as the decay in front of step t; each pair of A below the diagonal
    under one exponent, or ``split`` into 2^lc[t-1] * 2^-lc[s] (the
    factoring the kernel avoids); past T the rows are zero and the decay 1,
    and no y is kept there.  Returns (y, final state)."""
    B, T, H, hd = r.shape
    pad = (-T) % chunk

    def blocks(a):                  # [B, T, H, hd] -> [B, H, T + pad, hd]
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)).transpose(1, 2)
    r, k, v = blocks(r), blocks(k), blocks(v)
    lw = blocks(torch.log2(w.clamp(1e-8, 1.0)))
    below = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool), -1)
    S, ys = state.clone(), []
    for c0 in range(0, T + pad, chunk):
        rc, kc, vc = (x[:, :, c0:c0 + chunk] for x in (r, k, v))
        lc = torch.cumsum(lw[:, :, c0:c0 + chunk], dim=2)
        lp = torch.cat([torch.zeros_like(lc[:, :, :1]), lc[:, :, :-1]], 2)
        lct = lc[:, :, -1:]
        if split:
            dec = torch.exp2(lp)[:, :, :, None] \
                * torch.exp2(-lc)[:, :, None, :]
        else:
            dec = torch.exp2(torch.where(
                below[..., None], lp[:, :, :, None] - lc[:, :, None, :],
                -torch.inf))
        A = (rc[:, :, :, None] * kc[:, :, None] * dec
             * below[..., None]).sum(-1)
        A = A + torch.diag_embed((rc * u[None, :, None] * kc).sum(-1))
        ys.append((rc * torch.exp2(lp)) @ S + A @ vc)
        S = torch.exp2(lct).transpose(-1, -2) * S \
            + (kc * torch.exp2(lct - lc)).transpose(-1, -2) @ vc
    y = torch.cat(ys, 2).transpose(1, 2)[:, :T] if ys else r[:, :0]
    return y, S


@pytest.mark.parametrize("B,T,H,hd", WKV_SHAPES + [(1, 1, 2, 64),
                                                   (2, 17, 2, 64),
                                                   (1, 40, 1, 128)])
def test_chunked_wkv_design_matches_reference(B, T, H, hd):
    """The kernel's chunked scan, from a state, against the step-by-step
    plain version and the JAX model's ``wkv_chunked``; from zeros against
    the interpret-mode Pallas kernel; all at the kernel's atol 2e-3 /
    rtol 1e-3.  T = 1 and T = 17 leave most of a chunk past T."""
    rng = np.random.default_rng(T + hd + 1)
    r, k, v, w, u = wkv_inputs(rng, B, T, H, hd)
    state = randn(rng, (B, H, hd, hd), scale=0.5)
    y, s = chunked_wkv(*(t(a) for a in (r, k, v, w, u, state)))
    assert y.shape == (B, T, H, hd)
    yr, sr = tref.wkv_ref(*(t(a) for a in (r, k, v, w, u, state)))
    for got, want in ((y, yr), (s, sr)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3,
                                   rtol=1e-3)
    yj, sj = wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u, state)))
    np.testing.assert_allclose(y.numpy(), yj, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), sj, atol=2e-3, rtol=1e-3)
    zero = np.zeros_like(state)
    y0, s0 = chunked_wkv(*(t(a) for a in (r, k, v, w, u, zero)))
    yp, sp = wkv_pallas(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                        interpret=True)
    np.testing.assert_allclose(y0.numpy(), yp, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(s0.numpy(), sp, atol=2e-3, rtol=1e-3)


def test_chunked_wkv_design_extreme_decay():
    """w = 1e-8 over 48 steps at hd 64: one exponent a pair stays finite
    and within 1e-3 of the step-by-step version; 2^lc[t-1] * 2^-lc[s]
    overflows (-lc reaches 425 in base 2 over a chunk)."""
    rng = np.random.default_rng(8)
    B, T, H, hd = 1, 48, 1, 64
    r, k, v, _, u = wkv_inputs(rng, B, T, H, hd)
    w = np.full((B, T, H, hd), 1e-8, np.float32)
    state = np.zeros((B, H, hd, hd), np.float32)
    args = [t(a) for a in (r, k, v, w, u, state)]
    y, s = chunked_wkv(*args)
    assert np.isfinite(y.numpy()).all() and np.isfinite(s.numpy()).all()
    yr, sr = tref.wkv_ref(*args)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), sr.numpy(), atol=1e-3, rtol=1e-3)
    y_split, _ = chunked_wkv(*args, split=True)
    assert not np.isfinite(y_split.numpy()).all()


@pytest.mark.parametrize("B,T,D", RGLRU_SHAPES)
def test_rglru_plain_matches_reference(B, T, D):
    rng = np.random.default_rng(T + D)
    a = rng.uniform(0.8, 0.999, (B, T, D)).astype(np.float32)
    b = randn(rng, (B, T, D))
    h0 = randn(rng, (B, D))
    y, hT = ops.rglru(t(a), t(b), t(h0))
    yr, hr = jref.rglru_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), yr, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hT.numpy(), hr, atol=1e-5, rtol=1e-5)
    yp, hp = rglru_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                          interpret=True)
    np.testing.assert_allclose(y.numpy(), yp, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hT.numpy(), hp, atol=1e-5, rtol=1e-5)


def test_lm_kernel_wrappers_take_cuda_tensors_only():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru_scan import rglru_cuda
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    x = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x, x)
    a = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_cuda(a, a, a[:, 0])
    r = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_cuda(r, r, r, r, r[0, 0], torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError, match="no kernel"):
        ops.rglru(a.to("meta"), a.to("meta"), a[:, 0].to("meta"))
    assert jax.default_backend() == "cpu"
