"""The plain versions of the LM kernels (what the port's CPU path runs)
against ``repro.kernels.ref`` and the interpret-mode Pallas kernels, at
``tests/test_kernels.py``'s shapes and tolerances.  The hand-written
kernels are held against these plain versions on the card in
``tests/test_torch_kernels_cuda.py``."""
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
