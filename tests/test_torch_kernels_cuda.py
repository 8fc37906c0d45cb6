"""The hand-written kernels against their plain PyTorch versions on the
card, at ``tests/test_kernels.py``'s shapes and tolerances and at the
round's shapes.  Every case needs a CUDA GPU (marker ``requires_cuda``)
and skips without one; the file imports no JAX, so it also runs on a
GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref

SWAP_SHAPES = [(2, 16, 10), (1, 64, 10), (3, 7, 5), (2, 33, 100),
               (1, 130, 130)]
ADD_SHAPES = [(2, 16, 10), (1, 64, 10), (3, 7, 5), (2, 33, 100)]
PSG_SHAPES = [(64, 120, 10), (100, 512, 100), (32, 48, 5), (130, 64, 16)]


def wemd_inputs(B, V, C, size, seed):
    rng = np.random.default_rng(seed)
    p_dev = rng.dirichlet(np.full(C, 0.4), size=(B, V)).astype(np.float32)
    p_sum = p_dev[:, :size].sum(axis=1)
    gd = p_dev.mean(axis=1)
    cw = rng.uniform(0.5, 1.5, (B, C)).astype(np.float32)
    sizes = np.full((B,), float(size), np.float32)
    return p_sum, p_dev, gd, cw, sizes


def psg_inputs(B, d, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, d)).astype(np.float32),
            rng.normal(size=(B, C)).astype(np.float32),
            rng.integers(0, C, B).astype(np.int32))


def to_torch(args, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in args]

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,V,C", SWAP_SHAPES + [(32, 19, 10), (2, 300, 10)])
def test_wemd_swap_kernel_on_card(cuda, B, V, C):
    from repro_torch.kernels.wemd_swap import wemd_swap_cuda
    args = to_torch(wemd_inputs(B, V, C, min(5, V), seed=V), cuda)
    out = wemd_swap_cuda(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tref.wemd_swap_ref(*args), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,V,C", ADD_SHAPES + [(1, 19, 10), (2, 300, 10)])
def test_wemd_add_kernel_on_card(cuda, B, V, C):
    from repro_torch.kernels.wemd_swap import wemd_add_cuda
    args = to_torch(wemd_inputs(B, V, C, min(3, V), seed=V), cuda)
    out = wemd_add_cuda(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tref.wemd_add_ref(*args), atol=1e-5,
                               rtol=1e-5)


def wemd_kernel(kind):
    from repro_torch.kernels import wemd_swap as K
    return ((K.wemd_add_cuda, tref.wemd_add_ref) if kind == "add"
            else (K.wemd_swap_cuda, tref.wemd_swap_ref))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["add", "swap"])
@pytest.mark.parametrize("B,V,C", [(2, 16, 10), (32, 23, 10), (2, 33, 100),
                                   (1, 130, 130), (2, 300, 10)])
def test_wemd_kernel_f64_inputs_on_card(cuda, kind, B, V, C):
    """The scheduler's f64 state goes into the kernel as it is: the output
    is bitwise the kernel's on the f32-cast inputs, and within 1e-5 of the
    plain version (the f32 function the Pallas wrappers compute)."""
    kern, plain = wemd_kernel(kind)
    rng = np.random.default_rng(V + C)
    p_dev = rng.dirichlet(np.full(C, 0.4), size=(B, V))
    size = min(4, V)
    a64 = to_torch([p_dev[:, :size].sum(axis=1), p_dev, p_dev.mean(axis=1),
                    rng.uniform(0.5, 1.5, (B, C)),
                    np.full((B,), float(size))], cuda)
    assert all(a.dtype == torch.float64 for a in a64)
    a32 = [a.to(torch.float32) for a in a64]
    out64, out32 = kern(*a64), kern(*a32)
    torch.cuda.synchronize()
    assert out64.dtype == torch.float32
    assert torch.equal(out64, out32)
    torch.testing.assert_close(out64, plain(*a32), atol=1e-5, rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["add", "swap"])
def test_wemd_kernel_refuses_mixed_and_half_inputs(cuda, kind):
    kern, _ = wemd_kernel(kind)
    args = to_torch(wemd_inputs(2, 16, 10, 3, seed=1), cuda)
    mixed = [args[0].double()] + args[1:]
    with pytest.raises(ValueError, match="one dtype"):
        kern(*mixed)
    with pytest.raises(ValueError, match="f32 or f64"):
        kern(*[a.half() for a in args])
    with pytest.raises(ValueError, match="contiguous"):
        kern(args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2),
             *args[2:])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,d,C", PSG_SHAPES + [(32, 120, 10)])
def test_persample_gradnorm_kernel_on_card(cuda, B, d, C):
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda, persample_gradnorm_cuda_batched)
    args = to_torch(psg_inputs(B, d, C, seed=d), cuda)
    s, gi = persample_gradnorm_cuda(*args)
    torch.cuda.synchronize()
    sr, gr = tref.persample_gradnorm_ref(*args)
    torch.testing.assert_close(s, sr, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(gi, gr, atol=1e-2, rtol=1e-3)
    sb, gb = persample_gradnorm_cuda_batched(*(a[None] for a in args))
    torch.cuda.synchronize()
    torch.testing.assert_close(sb[0], s)
    torch.testing.assert_close(gb[0], gi)


ATTN_SHAPES = [(2, 3, 128, 128, 64), (1, 2, 256, 256, 64),
               (2, 2, 100, 100, 32), (1, 2, 64, 192, 64),
               (1, 1, 128, 128, 128), (1, 1, 257, 257, 64)]
WKV_SHAPES = [(2, 48, 3, 32), (1, 16, 2, 64), (2, 100, 2, 16), (1, 64, 1, 64)]
# T = 1 and T = 17 leave most of a chunk of 16 past T; T = 3072 is 192
# chunks (the rwkv6-3b prompt) for drift across chunk boundaries; hd 128
WKV_CARD_SHAPES = [(2, 1, 2, 64), (2, 17, 3, 64), (1, 3072, 2, 64),
                   (2, 40, 2, 128)]
RGLRU_SHAPES = [(2, 300, 64), (1, 128, 512), (3, 37, 100), (1, 1024, 256)]


def randn(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,S,T,hd", ATTN_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_attention_kernel_on_card(cuda, B, H, S, T, hd, causal, window):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    rng = np.random.default_rng(S + T + hd)
    q, k, v = to_torch([randn(rng, (B, H, n, hd)) for n in (S, T, T)], cuda)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, tref.attention_ref(q, k, v, causal=causal, window=window),
        atol=3e-5, rtol=1e-4)


@pytest.mark.requires_cuda
def test_attention_kernel_bf16_shared_kv_and_strides(cuda):
    """bf16 (atol 3e-2, as test_flash_attention_dtypes), one key head for
    ten query heads at hd 256 and a window, read through the model's
    [B, S, H, hd] strides."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    rng = np.random.default_rng(11)
    q, k, v = to_torch([randn(rng, (1, 2, 128, 64)) for _ in range(3)], cuda)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention_cuda(qb, kb, vb, causal=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(),
                               tref.attention_ref(qb, kb, vb).float(),
                               atol=3e-2, rtol=3e-2)
    B, S, H, hd = 2, 300, 10, 256
    q = torch.as_tensor(randn(rng, (B, S, H, hd)), device=cuda)
    kv = torch.as_tensor(randn(rng, (2, B, S, 1, hd)), device=cuda)
    args = (q.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2))
    out = flash_attention_cuda(*args, causal=True, window=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, tref.attention_ref(*args, causal=True, window=64),
        atol=3e-5, rtol=1e-4)


# The bf16 route (tensor cores) against its f32-accumulated plain version
# at one bf16 step, chip_smoke.py's BF16_ATTN_TOL: both round one f32
# function to bf16 once.  B, H, KV, S, T, hd; S and T off the kernel's
# 128-query and 64-key tiles; KV groups of 1, 2 and 10 query heads.
BF16_ATTN_TOL = (1e-3, 8e-3)
BF16_ATTN_CASES = [(1, 2, 2, 257, 257, 32), (2, 2, 1, 300, 300, 64),
                   (1, 4, 2, 257, 300, 128), (1, 10, 1, 300, 300, 256),
                   (1, 2, 2, 100, 300, 64),     # T > S: right-aligned
                   (1, 10, 1, 300, 100, 256)]   # T < S: causal rows see no key


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KV,S,T,hd", BF16_ATTN_CASES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0)])
def test_attention_kernel_bf16_on_card(cuda, B, H, KV, S, T, hd, causal,
                                       window):
    """Read through the model's [B, S, H, hd] strides; window 100 cuts
    inside a 64-key tile."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    rng = np.random.default_rng(S + T + hd + H + window)
    q = torch.as_tensor(randn(rng, (B, S, H, hd)), device=cuda)
    kv = torch.as_tensor(randn(rng, (2, B, T, KV, hd)), device=cuda)
    args = [x.to(torch.bfloat16).transpose(1, 2) for x in (q, kv[0], kv[1])]
    out = flash_attention_cuda(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (B, H, S, hd)
    want = tref.attention_ref(*args, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(),
                               atol=BF16_ATTN_TOL[0], rtol=BF16_ATTN_TOL[1])


@pytest.mark.requires_cuda
def test_attention_kernel_bf16_refuses_unaligned_rows(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    x = torch.zeros(1, 1, 9 * 64 + 4, dtype=torch.bfloat16, device=cuda)
    q = x[..., 4:].view(1, 1, 9, 64)           # 8 bytes past 16-byte alignment
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q, q, q)


def wkv_inputs(rng, B, T, H, hd, device):
    r = randn(rng, (B, T, H, hd))
    k = randn(rng, (B, T, H, hd), scale=0.3)
    v = randn(rng, (B, T, H, hd))
    w = (1 / (1 + np.exp(-rng.normal(size=(B, T, H, hd)) * 2)) * 0.6
         + 0.39).astype(np.float32)
    u = randn(rng, (H, hd), scale=0.1)
    s = randn(rng, (B, H, hd, hd), scale=0.5)
    return to_torch([r, k, v, w, u, s], device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,H,hd", WKV_SHAPES + WKV_CARD_SHAPES)
def test_wkv_kernel_on_card(cuda, B, T, H, hd):
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    args = wkv_inputs(np.random.default_rng(T + hd), B, T, H, hd, cuda)
    y, s = wkv_cuda(*args)
    torch.cuda.synchronize()
    yr, sr = tref.wkv_ref(*args)
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(s, sr, atol=2e-3, rtol=1e-3)


@pytest.mark.requires_cuda
def test_wkv_kernel_extreme_decay_on_card(cuda):
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    r, k, v, _, u, _ = wkv_inputs(np.random.default_rng(3), 1, 32, 1, 16,
                                  cuda)
    w = torch.full_like(r, 1e-4)
    s0 = torch.zeros((1, 1, 16, 16), device=cuda)
    y, _ = wkv_cuda(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, tref.wkv_ref(r, k, v, w, u, s0)[0],
                               atol=1e-3, rtol=1e-3)


@pytest.mark.requires_cuda
def test_wkv_kernel_decay_1e8_on_card(cuda):
    """w = 1e-8 over 48 steps at hd 64: -log w sums to 425 (base 2) over
    a chunk, so a split exponent would overflow; finite and within 1e-3."""
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    r, k, v, _, u, _ = wkv_inputs(np.random.default_rng(4), 1, 48, 1, 64,
                                  cuda)
    w = torch.full_like(r, 1e-8)
    s0 = torch.zeros((1, 1, 64, 64), device=cuda)
    y, s = wkv_cuda(r, k, v, w, u, s0)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    yr, sr = tref.wkv_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, yr, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(s, sr, atol=1e-3, rtol=1e-3)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H", [(0, 2), (2, 0)])
def test_wkv_kernel_empty_batch_on_card(cuda, B, H):
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    args = wkv_inputs(np.random.default_rng(1), B, 16, H, 64, cuda)
    before = LAUNCHES["wkv"]
    y, s = wkv_cuda(*args)
    assert y.shape == (B, 16, H, 64) and s.shape == (B, H, 64, 64)
    assert LAUNCHES["wkv"] == before


@pytest.mark.requires_cuda
def test_wkv_kernel_refuses_bad_inputs_on_card(cuda):
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    r, k, v, w, u, s = wkv_inputs(np.random.default_rng(2), 1, 16, 2, 64,
                                  cuda)
    flat = torch.zeros(r.numel() + 1, device=cuda)
    shifted = flat[1:].view(r.shape)              # 4 bytes past alignment
    with pytest.raises(ValueError, match="16-byte"):
        wkv_cuda(shifted, k, v, w, u, s)
    with pytest.raises(ValueError, match="f32"):
        wkv_cuda(r.double(), k, v, w, u, s)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,D", RGLRU_SHAPES)
def test_rglru_kernel_on_card(cuda, B, T, D):
    from repro_torch.kernels.rglru_scan import rglru_cuda
    rng = np.random.default_rng(T + D)
    a, b, h0 = to_torch([rng.uniform(0.8, 0.999, (B, T, D)).astype(
        np.float32), randn(rng, (B, T, D)), randn(rng, (B, D))], cuda)
    y, hT = rglru_cuda(a, b, h0)
    torch.cuda.synchronize()
    yr, hr = tref.rglru_ref(a, b, h0)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hT, hr, atol=1e-5, rtol=1e-5)
