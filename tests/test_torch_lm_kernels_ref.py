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


def scan_rglru(a, b, h0, run=8, pair_dtype=torch.float64):
    """The design of ``csrc/rglru_scan.cu`` in plain torch: T cut into runs
    of ``run`` steps; each run's pair (prod a, its h from 0) in
    ``pair_dtype``; the carry walks the runs in order in ``pair_dtype``;
    each run replays its steps in f32 from its carry-in rounded to f32
    (the kernel fuses a step's multiply and add, here they round
    separately).  Returns (h, h_T), h_T the last step's h."""
    carry, hs = h0.to(pair_dtype), []
    for t0 in range(0, a.shape[1], run):
        ar, br = a[:, t0:t0 + run], b[:, t0:t0 + run]
        A, H = torch.ones_like(carry), torch.zeros_like(carry)
        for j in range(ar.shape[1]):
            aj = ar[:, j].to(pair_dtype)
            A, H = A * aj, aj * H + br[:, j].to(pair_dtype)
        h = carry.to(torch.float32)
        for j in range(ar.shape[1]):
            h = ar[:, j] * h + br[:, j]
            hs.append(h)
        carry = A * carry + H
    return (torch.stack(hs, 1) if hs else torch.zeros_like(a)), \
        (hs[-1] if hs else h0)


def rglru_inputs(rng, B, T, D, a_val=None, scaled=False):
    """a in [0.8, 0.999] (the sweep's), or ``a_val`` everywhere; unit b,
    or b = sqrt(1 - a^2) x as RG-LRU forms it (``models/rglru.py``)."""
    a = (rng.uniform(0.8, 0.999, (B, T, D)) if a_val is None
         else np.full((B, T, D), a_val)).astype(np.float32)
    b = randn(rng, (B, T, D))
    if scaled:
        b = (np.sqrt(np.float32(1) - a * a) * b).astype(np.float32)
    return a, b, randn(rng, (B, D))


# T = 1, T off the run of 8 and the segment of 256 (257), D off the
# 4-channel groups (37), T = 3072 (the prompt: 384 runs of drift)
RGLRU_DESIGN_SHAPES = RGLRU_SHAPES + [(2, 1, 64), (2, 257, 37),
                                      (1, 3072, 64)]


@pytest.mark.parametrize("B,T,D", RGLRU_DESIGN_SHAPES)
def test_rglru_scan_design_matches_reference(B, T, D):
    """The kernel's time-parallel scan against the JAX package's
    step-by-step ``rglru_ref`` and the interpret-mode Pallas kernel at the
    kernel's 1e-5; h_T is the last step's h."""
    a, b, h0 = rglru_inputs(np.random.default_rng(T + D + 2), B, T, D)
    y, hT = scan_rglru(t(a), t(b), t(h0))
    assert y.shape == (B, T, D) and torch.equal(hT, y[:, -1])
    want = [jref.rglru_ref(*(jnp.asarray(x) for x in (a, b, h0)))]
    if T <= 1024:
        want.append(rglru_pallas(*(jnp.asarray(x) for x in (a, b, h0)),
                                 interpret=True))
    for yr, hr in want:
        np.testing.assert_allclose(y.numpy(), yr, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(hT.numpy(), hr, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("a_val", [0.0, 1.0, 0.9999])
@pytest.mark.parametrize("T,scaled", [(100, False), (3072, True)])
def test_rglru_scan_design_extreme_a(a_val, T, scaled):
    """a = 0, 1 and 0.9999 against the step-by-step plain version at
    1e-5: unit b over 100 steps, and b = sqrt(1 - a^2) x over 3072."""
    a, b, h0 = rglru_inputs(np.random.default_rng(17), 2, T, 64, a_val,
                            scaled)
    y, hT = scan_rglru(t(a), t(b), t(h0))
    yr, hr = tref.rglru_ref(t(a), t(b), t(h0))
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hT, hr, atol=1e-5, rtol=1e-5)


def test_rglru_scan_design_needs_f64_pairs():
    """At a = 0.9999 over 3072 steps (b = sqrt(1 - a^2) x), against the
    recurrence in f64: f32 pairs round prod a the same way in every run,
    so the carry drifts further from it than the step-by-step f32 plain
    version does; f64 pairs stay within a tenth of the 1e-5 bound, closer
    than the plain version.  At a = 1 with unit b over 3072 steps the
    step-by-step f32 sum is itself more than 1e-5 from the f64 sum, so
    there no order of f32 sums is held to 1e-5."""
    def worst(y, want):                 # over the 1e-5 + 1e-5 |want| bound
        return float(((y.double() - want).abs()
                      / (1e-5 + 1e-5 * want.abs())).max())

    a, b, h0 = (t(x) for x in rglru_inputs(np.random.default_rng(17), 2,
                                           3072, 64, 0.9999, True))
    exact, _ = tref.rglru_ref(a.double(), b.double(), h0.double())
    plain = worst(tref.rglru_ref(a, b, h0)[0], exact)
    assert worst(scan_rglru(a, b, h0)[0], exact) < min(0.1, plain)
    assert worst(scan_rglru(a, b, h0, pair_dtype=torch.float32)[0],
                 exact) > plain
    a, b, h0 = (t(x) for x in rglru_inputs(np.random.default_rng(17), 2,
                                           3072, 64, 1.0))
    exact, _ = tref.rglru_ref(a.double(), b.double(), h0.double())
    assert worst(tref.rglru_ref(a, b, h0)[0], exact) > 1


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
    # a meta tensor (the dry run's) takes the plain version: shapes only
    h, h_last = ops.rglru(a.to("meta"), a.to("meta"), a[:, 0].to("meta"))
    assert h.is_meta and h.shape == a.shape and h_last.shape == a[:, 0].shape
    assert jax.default_backend() == "cpu"


# ---------------------------------------------------------------------------
# the plain versions of the backward kernels (K4-bwd, K6-bwd) against
# jax.vjp of the JAX package's plain attention and RG-LRU

# B, H, KV, S, T, hd: GQA groups of 1, 2 and 10 query heads, T > S
# (queries right-aligned)
ATTN_BWD_CASES = [(2, 3, 3, 40, 40, 32), (1, 4, 2, 33, 33, 64),
                  (1, 10, 1, 48, 48, 256), (1, 2, 1, 20, 50, 32)]


@pytest.mark.parametrize("B,H,KV,S,T,hd", ATTN_BWD_CASES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_attention_bwd_plain_matches_reference_vjp(B, H, KV, S, T, hd,
                                                   causal, window):
    """dq, dk, dv of ``attention_bwd_ref`` against ``jax.vjp`` of
    ``repro.kernels.ref.attention_ref`` over key heads repeated to the
    query heads (so dk and dv sum over a group), at the forward's f32
    tolerance."""
    rng = np.random.default_rng(S + T + H + window)
    q, do = (randn(rng, (B, H, S, hd)) for _ in range(2))
    k, v = (randn(rng, (B, KV, T, hd)) for _ in range(2))
    G = H // KV

    def f(q, k, v):
        return jref.attention_ref(q, jnp.repeat(k, G, axis=1),
                                  jnp.repeat(v, G, axis=1), causal=causal,
                                  window=window)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = tref.attention_bwd_ref(t(q), t(k), t(v), t(do), causal=causal,
                                 window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=1e-4, err_msg=name)


def test_attention_bwd_plain_bf16_rounds_once():
    """On bf16 inputs the plain backward is the f32 one rounded to bf16
    once, in the inputs' dtype."""
    rng = np.random.default_rng(2)
    q, k, v, do = (t(randn(rng, (1, 4, 24, 32))).to(torch.bfloat16)
                   for _ in range(4))
    got = tref.attention_bwd_ref(q, k[:, :2], v[:, :2], do, window=8)
    want = tref.attention_bwd_ref(*(x.float() for x in (q, k[:, :2],
                                                        v[:, :2], do)),
                                  window=8)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


@pytest.mark.parametrize("B,T,D,a_val", [(2, 300, 64, None),
                                         (3, 37, 100, None),
                                         (2, 100, 37, 0.0), (2, 100, 37, 1.0),
                                         (2, 100, 37, 0.9999),
                                         (2, 1, 8, None)])
def test_rglru_bwd_plain_matches_reference_vjp(B, T, D, a_val):
    """da, db, dh0 of ``rglru_bwd_ref`` (the reverse recurrence written
    out, reading the forward's h) against ``jax.vjp`` of
    ``repro.kernels.ref.rglru_ref`` at the forward's 1e-5, with a
    gradient into h and into h_T; a = 0, 1 and 0.9999 included."""
    rng = np.random.default_rng(T + D)
    a = (rng.uniform(0.8, 0.999, (B, T, D)) if a_val is None
         else np.full((B, T, D), a_val)).astype(np.float32)
    b, dh = randn(rng, (B, T, D)), randn(rng, (B, T, D))
    h0, dT = randn(rng, (B, D)), randn(rng, (B, D))
    (h, _), vjp = jax.vjp(jref.rglru_ref, jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(h0))
    want = vjp((jnp.asarray(dh), jnp.asarray(dT)))
    got = tref.rglru_bwd_ref(t(a), t(np.array(h)), t(h0), t(dh), t(dT))
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_lm_backward_wrappers_take_cuda_tensors_only():
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rglru_scan import rglru_bwd_cuda
    x = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(x, x, x, x)
    a = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_bwd_cuda(a, a, a[:, 0], a, a[:, 0])


# ---------------------------------------------------------------------------
# K5-bwd: the plain version of the WKV backward against jax.vjp of the JAX
# package's plain recurrence and of the model's chunked scan, and the
# chunked design of csrc/wkv_bwd.cu in plain torch against the plain version

# B, T, H, hd: T = 37 and 20 leave a chunk of 16 partly past T
WKV_BWD_SHAPES = [(2, 48, 3, 32), (1, 16, 2, 64), (2, 100, 2, 16),
                  (1, 37, 1, 64), (1, 20, 2, 128)]
# f32 against f32 in other orders: the largest reading was 5.7e-5 on
# gradients up to 85 (wkv_chunked's vjp, which goes through exp and log)
WKV_BWD_TOL = dict(atol=2e-4, rtol=1e-4)


def wkv_bwd_inputs(rng, B, T, H, hd):
    """wkv_inputs, a non-zero initial state, and the outputs' gradients."""
    r, k, v, w, u = wkv_inputs(rng, B, T, H, hd)
    state = randn(rng, (B, H, hd, hd), scale=0.5)
    return (r, k, v, w, u, state, randn(rng, (B, T, H, hd)),
            randn(rng, (B, H, hd, hd)))


@pytest.mark.parametrize("B,T,H,hd", WKV_BWD_SHAPES)
def test_wkv_bwd_plain_matches_reference_vjp(B, T, H, hd):
    """dr, dk, dv, dw, du and the initial state's gradient of
    ``wkv_bwd_ref`` against ``jax.vjp`` of ``repro.kernels.ref.wkv_ref``
    and of ``repro.models.rwkv6.wkv_chunked``, from a non-zero state with
    gradients into y and into the final state, at ``WKV_BWD_TOL``."""
    args = wkv_bwd_inputs(np.random.default_rng(T + hd + 3), B, T, H, hd)
    got = tref.wkv_bwd_ref(*(t(a) for a in args))
    for fn in (jref.wkv_ref, wkv_chunked):
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args[:6]))
        want = vjp((jnp.asarray(args[6]), jnp.asarray(args[7])))
        for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                              want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{fn.__name__} {name}",
                                       **WKV_BWD_TOL)


def test_wkv_bwd_plain_clip_gradient():
    """Where the clip of w to [1e-8, 1] binds, dw is jnp.clip's: 0 below
    1e-8 (1e-9 here) and 1/2 on a bound (w = 1 exactly), against
    ``jax.vjp`` of the model's ``wkv_chunked``, which clips.  (On the
    lower bound, w = 1e-8 exactly, ``wkv_chunked``'s vjp multiplies its
    gradient by 1/w = 1e8 after a log, so its f32 reading there is not a
    reference.)"""
    B, T, H, hd = 1, 24, 2, 16
    args = list(wkv_bwd_inputs(np.random.default_rng(11), B, T, H, hd))
    w = args[3]
    w[:, 2] = 1.0
    w[:, 5, :, :4] = 1e-9
    got = tref.wkv_bwd_ref(*(t(a) for a in args))
    _, vjp = jax.vjp(wkv_chunked, *(jnp.asarray(a) for a in args[:6]))
    want = vjp((jnp.asarray(args[6]), jnp.asarray(args[7])))
    assert np.all(got[3][:, 5, :, :4].numpy() == 0)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), err_msg=name,
                                   **WKV_BWD_TOL)


def chunked_wkv_bwd(r, k, v, w, u, state, dy, dstate, chunk=16):
    """The design of ``csrc/wkv_bwd.cu`` in plain torch, in f32: the
    forward's chunk-entry states, then the chunks walked from the last,
    carrying G; per chunk a[t] = 2^(lct - lc[t]), b[t] = 2^lc[t-1] and
    e[t][s] = 2^(lc[t-1] - lc[s]) for s < t (each exponent <= 0), B[t][s]
    = dy_t . v_s, SD[t] = S0 dy_t, GV[t] = G v_t, X = rowsum(G * S0), and
    the kernel's formulas for dr, dk, dv, dw (with jnp.clip's gradient),
    du and G.  Past T the rows are zero and the decay 1."""
    B, T, H, hd = r.shape
    L, pad = chunk, (-T) % chunk

    def blocks(a, value=0.0):       # [B, T, H, hd] -> [B, H, T + pad, hd]
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad),
                                       value=value).transpose(1, 2)
    rb, kb, vb, dyb, wb = (blocks(r), blocks(k), blocks(v), blocks(dy),
                           blocks(w, 1.0))
    lw = torch.log2(wb.clamp(1e-8, 1.0))
    lo = torch.tensor(1e-8).item()
    clip_grad = torch.where((wb > lo) & (wb < 1), 1.0, torch.where(
        (wb == lo) | (wb == 1), 0.5, 0.0))
    below = torch.tril(torch.ones(L, L, dtype=torch.bool), -1)
    uu = u[None, :, None]
    S, starts = state.clone(), []
    for c0 in range(0, T + pad, L):
        starts.append(S)
        lc = torch.cumsum(lw[:, :, c0:c0 + L], 2)
        lct = lc[:, :, -1:]
        S = torch.exp2(lct).transpose(-1, -2) * S + (
            kb[:, :, c0:c0 + L] * torch.exp2(lct - lc)).transpose(-1, -2) \
            @ vb[:, :, c0:c0 + L]
    G = dstate.clone()
    grads = [torch.zeros_like(rb) for _ in range(4)]
    du = torch.zeros_like(u)
    for c0 in range(T + pad - L, -1, -L):
        S0 = starts[c0 // L]
        rc, kc, vc, dyc = (x[:, :, c0:c0 + L] for x in (rb, kb, vb, dyb))
        lc = torch.cumsum(lw[:, :, c0:c0 + L], 2)
        lp = torch.cat([torch.zeros_like(lc[:, :, :1]), lc[:, :, :-1]], 2)
        lct = lc[:, :, -1:]
        a, b = torch.exp2(lct - lc), torch.exp2(lp)
        e = torch.exp2(torch.where(below[..., None], lp[:, :, :, None]
                                   - lc[:, :, None, :], -torch.inf))
        Bm = dyc @ vc.transpose(-1, -2)
        Bd = torch.diagonal(Bm, dim1=-2, dim2=-1)[..., None]
        A = (rc[:, :, :, None] * kc[:, :, None] * e).sum(-1) \
            + torch.diag_embed((rc * uu * kc).sum(-1))
        SD, GV = dyc @ S0.transpose(-1, -2), vc @ G.transpose(-1, -2)
        X = (G * S0).sum(-1)[:, :, None]
        ek = e * kc[:, :, None]                  # [t, q, d] e[t][q] k_q
        er = e * rc[:, :, :, None]               # [s, t, d] e[s][t] r_s
        z = b[:, :, None] * SD[:, :, :, None] \
            + torch.einsum("bhtqd,bhsq->bhstd", ek, Bm)
        out = (b * SD + (Bm[..., None] * ek).sum(3) + uu * kc * Bd,
               a * GV + (Bm[..., None] * er).sum(2) + rc * uu * Bd,
               (kc * a) @ G + A.transpose(-1, -2) @ dyc,
               (a * (b * X + (ek * GV[:, :, None]).sum(3))
                + (er * z).sum(2)) * clip_grad[:, :, c0:c0 + L])
        for g, o in zip(grads, out):
            g[:, :, c0:c0 + L] = o
        du += (rc * kc * Bd).sum((0, 2))
        G = torch.exp2(lct).transpose(-1, -2) * G \
            + (rc * b).transpose(-1, -2) @ dyc
    return (*(g.transpose(1, 2)[:, :T] for g in grads), du, G)


@pytest.mark.parametrize("B,T,H,hd", WKV_BWD_SHAPES + [(2, 1, 2, 32),
                                                       (1, 0, 1, 16)])
def test_chunked_wkv_bwd_design_matches_plain(B, T, H, hd):
    """The kernel's chunked backward against the step-by-step plain
    version at ``WKV_BWD_TOL``; T = 1 leaves 15 steps of the chunk past T,
    T = 0 has no chunk (dstate passes through, du is 0)."""
    args = [t(a) for a in wkv_bwd_inputs(np.random.default_rng(T + hd + 5),
                                         B, T, H, hd)]
    got = chunked_wkv_bwd(*args)
    want = tref.wkv_bwd_ref(*args)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                          want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **WKV_BWD_TOL)


def test_chunked_wkv_bwd_design_extreme_decay():
    """w = 1e-8 over 48 steps at hd 64, and a run of w = 1: every factor
    of the design is at most 1, so the gradients stay finite and within
    ``WKV_BWD_TOL`` of the plain version in f64 (the state's memory lasts
    one step, so each gradient reads only its neighbours)."""
    rng = np.random.default_rng(9)
    B, T, H, hd = 1, 48, 1, 64
    args = list(wkv_bwd_inputs(rng, B, T, H, hd))
    args[3] = np.full((B, T, H, hd), 1e-8, np.float32)
    args[3][:, 20:30] = 1.0
    got = chunked_wkv_bwd(*(t(a) for a in args))
    want = tref.wkv_bwd_ref(*(t(a).double() for a in args))
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                          want):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **WKV_BWD_TOL)


def test_wkv_bwd_plain_f64_is_the_truth():
    """On f64 inputs the plain backward runs in f64 (the truth the card's
    kernel is held against), and its f32 run lies within
    ``WKV_BWD_TOL`` of it."""
    args = wkv_bwd_inputs(np.random.default_rng(12), 1, 33, 2, 32)
    exact = tref.wkv_bwd_ref(*(t(a).double() for a in args))
    f32 = tref.wkv_bwd_ref(*(t(a) for a in args))
    for g, w in zip(f32, exact):
        assert w.dtype == torch.float64 and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), **WKV_BWD_TOL)


def test_wkv_autograd_on_cpu_is_the_plain_backward():
    """``ops.wkv`` on CPU tensors under autograd (the CPU route) gives the
    plain backward's gradients, bf16 r, k, v included."""
    args = [t(a).requires_grad_(True) for a in
            wkv_bwd_inputs(np.random.default_rng(13), 2, 21, 2, 16)[:6]]
    dy, ds = (t(a) for a in wkv_bwd_inputs(np.random.default_rng(14), 2, 21,
                                           2, 16)[6:])
    y, s = ops.wkv(*args)
    got = torch.autograd.grad((y, s), args, (dy, ds))
    want = tref.wkv_bwd_ref(*(a.detach() for a in args), dy, ds)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **WKV_BWD_TOL)


def test_wkv_bwd_wrapper_takes_cuda_tensors_only():
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    r = torch.zeros(1, 4, 2, 16)
    s = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_bwd_cuda(r, r, r, r, r[0, 0], s[:, None], r, s)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_cuda(r, r, r, r, r[0, 0], s, save_chunks=True)
