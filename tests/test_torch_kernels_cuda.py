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
from _torch_psg import (psg_aligned, psg_resnet_head, round_tolerance,
                        sigma_f64)

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


# the ResNet18-GN rounds' 100 classes: one cell at V = 64, 8 problems of
# an 8-cell GS solve, the 32 lanes of an FSCD solve
RESNET_WEMD_SHAPES = [(1, 64, 100), (8, 27, 100), (32, 23, 100)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,V,C", SWAP_SHAPES + [(32, 19, 10), (2, 300, 10),
                                                 (40, 28, 10)]
                         + RESNET_WEMD_SHAPES)
def test_wemd_swap_kernel_on_card(cuda, B, V, C):
    from repro_torch.kernels.wemd_swap import wemd_swap_cuda
    args = to_torch(wemd_inputs(B, V, C, min(5, V), seed=V), cuda)
    out = wemd_swap_cuda(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tref.wemd_swap_ref(*args), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,V,C", ADD_SHAPES + [(1, 19, 10), (2, 300, 10),
                                                (8, 28, 10)]
                         + RESNET_WEMD_SHAPES)
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
                                   (1, 130, 130), (2, 300, 10)]
                         + RESNET_WEMD_SHAPES)
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


# the round's shape at V = 23; B off 32 with d off 4 (4-byte copies); 100
# classes (7 blocks of 16); (100, 512, 100): h in two column tiles
PSG_BATCHED_CASES = [(23, 32, 120, 10), (3, 33, 37, 10), (2, 32, 120, 100),
                     (2, 100, 512, 100),
                     (200, 32, 120, 10),     # one 8-cell round's launch
                     # ResNet18-GN: one cell, and 8 cells in one launch
                     (19, 32, 512, 100), (152, 32, 512, 100)]


def psg_batched(V, B, d, C, seed, device):
    rng = np.random.default_rng(seed)
    return to_torch([rng.normal(size=(V, B, d)).astype(np.float32),
                     rng.normal(size=(V, B, C)).astype(np.float32),
                     rng.integers(0, C, (V, B))], device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("V,B,d,C", PSG_BATCHED_CASES)
def test_persample_gradnorm_kernel_labels_on_card(cuda, V, B, d, C):
    """int64 labels (the round's) and int32 labels read as they come give
    one bit pattern, within sigma 1e-3 and gi_sq atol 1e-2 of the plain
    version; a second call gives the same bits."""
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched)
    h, logits, labels = psg_batched(V, B, d, C, V + B + d + C, cuda)
    assert labels.dtype == torch.int64
    s64, g64 = persample_gradnorm_cuda_batched(h, logits, labels)
    s32, g32 = persample_gradnorm_cuda_batched(h, logits,
                                               labels.to(torch.int32))
    again = persample_gradnorm_cuda_batched(h, logits, labels)
    torch.cuda.synchronize()
    assert torch.equal(s64, s32) and torch.equal(g64, g32)
    assert torch.equal(s64, again[0]) and torch.equal(g64, again[1])
    sr, gr = tref.persample_gradnorm_ref(h, logits, labels)
    torch.testing.assert_close(s64, sr, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(g64, gr, atol=1e-2, rtol=1e-3)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("V,B,d,C", [(8, 32, 120, 10), (2, 100, 512, 100),
                                     (19, 32, 512, 100),
                                     (152, 32, 512, 100)])
def test_persample_gradnorm_kernel_aligned_gradients_on_card(cuda, V, B, d,
                                                             C):
    """Where the per-sample gradients nearly agree (mean ||g_i||^2 /
    sigma^2 ~ 1e5) the kernel's sum over the deviations stays within
    1e-5 of Eq. 10 in f64; the TPU kernel's one-pass sum lost
    three digits there (tests/test_torch_kernels_ref.py::
    test_sigma_two_pass_needed).  (100, 512, 100) takes column tiles."""
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched)
    h, logits, labels = to_torch(psg_aligned(V, B, d, C, V + d), cuda)
    s, _ = persample_gradnorm_cuda_batched(h, logits, labels)
    torch.cuda.synchronize()
    torch.testing.assert_close(s.double(), sigma_f64(h, logits, labels),
                               atol=0, rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("V", [19, 152])
def test_persample_gradnorm_kernel_resnet_head_on_card(cuda, V):
    """At ResNet18-GN's head (d = 512, C = 100; one cell, and 8 cells in
    one launch) sigma holds the FL round's tolerance against Eq. 10 in
    f64, with a tenth of it to spare (an f32 total of the deviations'
    6400 squares a thread did not: tests/test_torch_kernels_ref.py::
    test_sigma_f64_total_needed_at_resnet_head)."""
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched)
    h, logits, labels = to_torch(psg_resnet_head(V, 32, 512, 100, V), cuda)
    s, _ = persample_gradnorm_cuda_batched(h, logits, labels)
    torch.cuda.synchronize()
    truth = sigma_f64(h, logits, labels)
    err = (s.double() - truth).abs()
    assert bool((err <= 0.1 * round_tolerance(h, truth)).all())


@pytest.mark.requires_cuda
def test_persample_gradnorm_kernel_no_device_on_card(cuda):
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched)
    h, logits, labels = psg_batched(0, 32, 120, 10, 1, cuda)
    before = LAUNCHES["persample_gradnorm"]
    sigma, gi_sq = persample_gradnorm_cuda_batched(h, logits, labels)
    assert sigma.shape == (0,) and gi_sq.shape == (0, 32)
    assert LAUNCHES["persample_gradnorm"] == before


ATTN_SHAPES = [(2, 3, 128, 128, 64), (1, 2, 256, 256, 64),
               (2, 2, 100, 100, 32), (1, 2, 64, 192, 64),
               (1, 1, 128, 128, 128), (1, 1, 257, 257, 64)]
WKV_SHAPES = [(2, 48, 3, 32), (1, 16, 2, 64), (2, 100, 2, 16), (1, 64, 1, 64)]
# T = 1 and T = 17 leave most of a chunk of 16 past T; T = 3072 is 192
# chunks (the rwkv6-3b prompt) for drift across chunk boundaries; hd 128
WKV_CARD_SHAPES = [(2, 1, 2, 64), (2, 17, 3, 64), (1, 3072, 2, 64),
                   (2, 40, 2, 128)]
RGLRU_SHAPES = [(2, 300, 64), (1, 128, 512), (3, 37, 100), (1, 1024, 256)]
# T = 1; T off the run of 8 and the segment of 256 steps (257, 100); D = 37
# (off the 4-channel groups: the kernel's scalar loads); T = 3072, the
# prompt: 12 segments of carry
RGLRU_CARD_SHAPES = [(2, 1, 64), (2, 257, 37), (3, 100, 37),
                     (1, 3072, 256)]


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


# the LM zoo's prefill shapes, cut in batch and heads: hd 128 with GQA
# groups of 2 (gemma3-27b), 4 (llama-3.2-vision-11b), 7 (qwen2-7b, yi-34b,
# arctic-480b) and 16 (qwen3-moe-235b-a22b); gemma3's window of 1024 at
# its 3072-token prompt; llama-vision's cross attention, 3072 queries over
# 1601 encoder keys (off the 64-key tile), non-causal; musicgen-large's
# hd 64 with one query head a key head.  B, H, KV, S, T, hd, causal,
# window.
ZOO_ATTN_CASES = [(1, 4, 2, 300, 300, 128, True, 0),
                  (1, 8, 2, 300, 300, 128, True, 0),
                  (1, 14, 2, 257, 257, 128, True, 0),
                  (1, 16, 1, 300, 300, 128, True, 0),
                  (1, 4, 2, 3072, 3072, 128, True, 1024),
                  (1, 4, 1, 3072, 1601, 128, False, 0),
                  (2, 4, 4, 300, 300, 64, True, 0)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window", ZOO_ATTN_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_kernel_zoo_shapes_on_card(cuda, B, H, KV, S, T, hd,
                                            causal, window, dtype):
    """Both routes at the zoo's shapes, read through the model's
    [B, S, H, hd] strides: bf16 at ``BF16_ATTN_TOL``, f32 at atol 3e-5 /
    rtol 1e-4."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    rng = np.random.default_rng(S + T + hd + H + window)
    q = torch.as_tensor(randn(rng, (B, S, H, hd)), device=cuda)
    kv = torch.as_tensor(randn(rng, (2, B, T, KV, hd)), device=cuda)
    dt = getattr(torch, dtype)
    args = [x.to(dt).transpose(1, 2) for x in (q, kv[0], kv[1])]
    out = flash_attention_cuda(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == (B, H, S, hd)
    want = tref.attention_ref(*args, causal=causal, window=window)
    tol = BF16_ATTN_TOL if dt == torch.bfloat16 else (3e-5, 1e-4)
    torch.testing.assert_close(out.float(), want.float(), atol=tol[0],
                               rtol=tol[1])


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


# K5-bwd.  Truth: the plain backward in f64; the kernel's max abs error on
# each gradient may be at most WKV_BWD_ERR_MULT times the f32 plain
# version's (or 2^-24 of the gradient's largest entry, where that is
# larger).  The first card run read ratios of 0.55-8.4 (8.4: dw at hd
# 128; at the train shape 0.75-3.0): the kernel's decays go through
# ex2/lg2.approx and its sums run in other orders.
WKV_BWD_ERR_MULT = 16
# B, T, H, hd: every head size, T off the chunk of 16 (T = 1, 17, 37, 250)
WKV_BWD_CARD_SHAPES = [(2, 48, 3, 32), (1, 37, 1, 64), (1, 20, 2, 128),
                       (2, 17, 3, 16), (2, 1, 2, 64), (4, 250, 8, 64),
                       (2, 100, 4, 128)]


def wkv_bwd_case(rng, B, T, H, hd, device):
    args = wkv_inputs(rng, B, T, H, hd, device)
    dy, ds = to_torch([randn(rng, (B, T, H, hd)),
                       randn(rng, (B, H, hd, hd))], device)
    return args, dy, ds


def assert_wkv_bwd_close(got, args, dy, ds):
    """``got`` (dr, dk, dv, dw, du, dstate) against the f64 plain backward,
    at ``WKV_BWD_ERR_MULT`` times the f32 plain version's error."""
    plain = tref.wkv_bwd_ref(*args, dy, ds)
    truth = tref.wkv_bwd_ref(*(x.double() for x in (*args, dy, ds)))
    for name, g, p, t in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                             plain, truth):
        assert g.dtype == torch.float32 and g.shape == t.shape, name
        err = float((g.double() - t).abs().max())
        floor = max(float((p.double() - t).abs().max()),
                    2.0 ** -24 * float(t.abs().max()))
        assert err <= WKV_BWD_ERR_MULT * floor, (name, err, floor)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,H,hd", WKV_BWD_CARD_SHAPES)
def test_wkv_bwd_kernel_on_card(cuda, B, T, H, hd):
    """K5-bwd from the forward's chunk states against the f64 plain
    backward; the chunk states are the states the forward reaches; two
    calls give the same bits."""
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    args, dy, ds = wkv_bwd_case(np.random.default_rng(T + hd + 40), B, T, H,
                                hd, cuda)
    y, s, chunks = wkv_cuda(*args, save_chunks=True)
    y2, s2 = wkv_cuda(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert chunks.shape == (B, -(-T // 16), H, hd, hd)
    torch.testing.assert_close(chunks[:, 0], args[5], atol=0, rtol=0)
    if T > 16:
        head = [x[:, :16].contiguous() for x in args[:4]]
        torch.testing.assert_close(chunks[:, 1], wkv_cuda(
            *head, *args[4:])[1], atol=0, rtol=0)
    got = wkv_bwd_cuda(*args[:5], chunks, dy, ds)
    again = wkv_bwd_cuda(*args[:5], chunks, dy, ds)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert_wkv_bwd_close(got, args, dy, ds)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("wval", [1e-8, 1e-4])
def test_wkv_bwd_kernel_extreme_decay_on_card(cuda, wval):
    """w = 1e-8 (and 1e-4) over 48 steps at hd 64 with a run of w = 1:
    every factor of the kernel is at most 1, so the gradients are finite
    and held to the f64 plain backward as above."""
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    args, dy, ds = wkv_bwd_case(np.random.default_rng(5), 1, 48, 1, 64,
                                cuda)
    args[3] = torch.full_like(args[3], wval)
    args[3][:, 20:30] = 1.0
    chunks = wkv_cuda(*args, save_chunks=True)[2]
    got = wkv_bwd_cuda(*args[:5], chunks, dy, ds)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert_wkv_bwd_close(got, args, dy, ds)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("wval", [1e-8, 1e-4])
def test_wkv_bwd_kernel_extreme_decay_hd128_on_card(cuda, wval):
    """``test_wkv_bwd_kernel_extreme_decay_on_card`` at hd 128, whose
    blocks have twice the threads and other warp roles."""
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    args, dy, ds = wkv_bwd_case(np.random.default_rng(6), 1, 48, 1, 128,
                                cuda)
    args[3] = torch.full_like(args[3], wval)
    args[3][:, 20:30] = 1.0
    chunks = wkv_cuda(*args, save_chunks=True)[2]
    got = wkv_bwd_cuda(*args[:5], chunks, dy, ds)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert_wkv_bwd_close(got, args, dy, ds)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("scale", [(1e3, 1e3), (1e-3, 1e-3), (1e3, 1e-3)])
def test_wkv_bwd_kernel_scaled_inputs_on_card(cuda, hd, scale):
    """r and v scaled by ``scale[0]``, k and dy by ``scale[1]``: the
    tensor-core products split each operand into TF32 hi + lo, which
    loses digits first where the operands are far from 1; held to the
    f64 plain backward as above."""
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    args, dy, ds = wkv_bwd_case(np.random.default_rng(hd + 8), 2, 37, 2,
                                hd, cuda)
    for i, c in ((0, scale[0]), (1, scale[1]), (2, scale[0])):
        args[i] = args[i] * c
    dy = dy * scale[1]
    chunks = wkv_cuda(*args, save_chunks=True)[2]
    got = wkv_bwd_cuda(*args[:5], chunks, dy, ds)
    assert_wkv_bwd_close(got, args, dy, ds)


@pytest.mark.requires_cuda
def test_wkv_bwd_kernel_unaligned_dy_on_card(cuda):
    """A dy off 16-byte alignment (a view one float into its storage)
    gives the same bits as an aligned copy of it."""
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    args, dy, ds = wkv_bwd_case(np.random.default_rng(4), 1, 20, 2, 64, cuda)
    chunks = wkv_cuda(*args, save_chunks=True)[2]
    off = torch.empty(dy.numel() + 1, device=cuda)[1:].view(dy.shape)
    off.copy_(dy)
    assert off.data_ptr() % 16
    got = wkv_bwd_cuda(*args[:5], chunks, off, ds)
    want = wkv_bwd_cuda(*args[:5], chunks, dy, ds)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,T", [(0, 2, 16), (2, 0, 16), (2, 2, 0)])
def test_wkv_bwd_kernel_empty_on_card(cuda, B, H, T):
    """No batch or head: no launch; no step: dstate passes through and du
    is 0."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    args, dy, ds = wkv_bwd_case(np.random.default_rng(2), B, T, H, 64, cuda)
    chunks = wkv_cuda(*args, save_chunks=True)[2]
    before = LAUNCHES["wkv_bwd"]
    got = wkv_bwd_cuda(*args[:5], chunks, dy, ds)
    torch.cuda.synchronize()
    assert LAUNCHES["wkv_bwd"] == before + (B * H > 0)
    if B * H:
        assert torch.equal(got[5], ds) and not bool(got[4].any())


@pytest.mark.requires_cuda
def test_wkv_fn_matches_cpu_autograd_on_card(cuda):
    """``ops.wkv`` under autograd on the card (K5 saving chunk states,
    then K5-bwd) against autograd of the plain version on the CPU, bf16
    r, k, v cast in front as the model's are; one launch of each."""
    from repro_torch.kernels import common, ops
    args, dy, ds = wkv_bwd_case(np.random.default_rng(7), 2, 40, 2, 64,
                                cuda)
    common.reset_launches()
    card = [x.to(torch.bfloat16) if i < 3 else x.clone()
            for i, x in enumerate(args)]
    cpu = [x.cpu() for x in card]
    outs = []
    for leaves, d in ((card, cuda), (cpu, torch.device("cpu"))):
        leaves = [x.requires_grad_(True) for x in leaves]
        y, s = ops.wkv(*leaves)
        outs.append(torch.autograd.grad((y, s), leaves,
                                        (dy.to(d, torch.bfloat16), ds.to(d))))
    assert dict(common.LAUNCHES) == {"wkv": 1, "wkv_bwd": 1}
    for g, w in zip(*outs):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g.cpu().float(), w.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.requires_cuda
def test_wkv_bwd_kernel_refuses_bad_inputs_on_card(cuda):
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    args, dy, ds = wkv_bwd_case(np.random.default_rng(3), 1, 20, 2, 64, cuda)
    chunks = wkv_cuda(*args, save_chunks=True)[2]
    with pytest.raises(ValueError, match="chunk states"):
        wkv_bwd_cuda(*args[:5], chunks[:, :1].contiguous(), dy, ds)
    with pytest.raises(ValueError, match="chunk states"):
        wkv_bwd_cuda(*args[:5], chunks, dy.double(), ds)


def rglru_inputs(rng, B, T, D, device, a_val=None, scaled=False):
    """a in [0.8, 0.999], or ``a_val`` everywhere; unit b, or b =
    sqrt(1 - a^2) x as RG-LRU forms it; h0 ~ N(0, 1)."""
    a = (rng.uniform(0.8, 0.999, (B, T, D)) if a_val is None
         else np.full((B, T, D), a_val)).astype(np.float32)
    b = randn(rng, (B, T, D))
    if scaled:
        b = (np.sqrt(np.float32(1) - a * a) * b).astype(np.float32)
    return to_torch([a, b, randn(rng, (B, D))], device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,D", RGLRU_SHAPES + RGLRU_CARD_SHAPES)
def test_rglru_kernel_on_card(cuda, B, T, D):
    """Within 1e-5 of the step-by-step plain version, h and h_T (h_T is
    the last step's h, bit for bit), from a non-zero h0."""
    from repro_torch.kernels.rglru_scan import rglru_cuda
    a, b, h0 = rglru_inputs(np.random.default_rng(T + D), B, T, D, cuda)
    y, hT = rglru_cuda(a, b, h0)
    torch.cuda.synchronize()
    yr, hr = tref.rglru_ref(a, b, h0)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hT, hr, atol=1e-5, rtol=1e-5)
    assert torch.equal(hT, y[:, -1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("a_val", [0.0, 1.0, 0.9999])
@pytest.mark.parametrize("T,D,scaled", [(100, 64, False), (100, 37, False),
                                        (3072, 64, True)])
def test_rglru_kernel_extreme_a_on_card(cuda, a_val, T, D, scaled):
    """a = 0, 1 and 0.9999 at 1e-5: unit b over 100 steps, and b =
    sqrt(1 - a^2) x over 3072 (tests/test_torch_lm_kernels_ref.py says
    why unit b is not run over 3072 steps at a = 1)."""
    from repro_torch.kernels.rglru_scan import rglru_cuda
    a, b, h0 = rglru_inputs(np.random.default_rng(17), 2, T, D, cuda, a_val,
                            scaled)
    y, hT = rglru_cuda(a, b, h0)
    torch.cuda.synchronize()
    yr, hr = tref.rglru_ref(a, b, h0)
    torch.testing.assert_close(y, yr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hT, hr, atol=1e-5, rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,D", [(4, 3072, 2560), (2, 257, 37)])
def test_rglru_kernel_repeatable_on_card(cuda, B, T, D):
    """Two calls on one input give one bit pattern (no atomics, a fixed
    order of sums), at the recurrentgemma-2b prefill shape too."""
    from repro_torch.kernels.rglru_scan import rglru_cuda
    a, b, h0 = rglru_inputs(np.random.default_rng(5), B, T, D, cuda)
    y1, h1 = rglru_cuda(a, b, h0)
    y2, h2 = rglru_cuda(a, b, h0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


# ---------------------------------------------------------------------------
# the backward kernels (K4-bwd, K6-bwd) and the gradient route of ops

# B, H, KV, S, T, hd: the forward's sweep; ten query heads on one key head
# at hd 256 (recurrentgemma-2b's layout); T > S (queries right-aligned);
# S off the 32-row tiles
ATTN_BWD_CASES = [(B, H, H, S, T, hd) for B, H, S, T, hd in ATTN_SHAPES] + [
    (2, 10, 1, 300, 300, 256), (1, 4, 2, 100, 300, 128),
    (2, 10, 1, 256, 256, 256)]


def attn_bwd_inputs(rng, B, H, KV, S, T, hd, dtype, device):
    """q, k, v through the model's [B, S, H, hd] strides, and dO."""
    q = torch.as_tensor(randn(rng, (B, S, H, hd)), device=device)
    kv = torch.as_tensor(randn(rng, (2, B, T, KV, hd)), device=device)
    do = torch.as_tensor(randn(rng, (B, S, H, hd)), device=device)
    return [x.to(dtype).transpose(1, 2) for x in (q, kv[0], kv[1], do)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KV,S,T,hd", ATTN_BWD_CASES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_attention_bwd_kernel_on_card(cuda, B, H, KV, S, T, hd, causal,
                                      window):
    """dq, dk, dv against autograd of the plain version, f32 at the
    forward's tolerances (atol 3e-5, rtol 1e-4); dk and dv sum over a
    key head's query heads."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = attn_bwd_inputs(np.random.default_rng(S + T + H), B, H,
                                  KV, S, T, hd, torch.float32, cuda)
    got = flash_attention_bwd_cuda(q, k, v, do, causal=causal, window=window)
    torch.cuda.synchronize()
    want = tref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        torch.testing.assert_close(g, w, atol=3e-5, rtol=1e-4, msg=name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KV,S,T,hd", [(1, 2, 2, 257, 257, 32),
                                           (2, 10, 1, 300, 300, 256),
                                           (1, 4, 2, 100, 300, 128),
                                           # GQA groups of 1 and 2 at head
                                           # sizes 32, 64 and 128
                                           (2, 3, 3, 128, 128, 64),
                                           (1, 2, 2, 100, 100, 128),
                                           (2, 4, 2, 130, 130, 32),
                                           (1, 4, 2, 256, 256, 64),
                                           (2, 2, 1, 70, 200, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100)])
def test_attention_bwd_kernel_bf16_on_card(cuda, B, H, KV, S, T, hd, causal,
                                           window):
    """bf16 inputs (the tensor-core route): the f32 sums rounded to bf16
    once, as the plain version's autograd rounds its f32 gradients: one
    bf16 step apart (the forward's BF16_ATTN_TOL)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = attn_bwd_inputs(np.random.default_rng(S + hd), B, H, KV,
                                  S, T, hd, torch.bfloat16, cuda)
    got = flash_attention_bwd_cuda(q, k, v, do, causal=causal, window=window)
    torch.cuda.synchronize()
    want = tref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=BF16_ATTN_TOL[0],
                                   rtol=BF16_ATTN_TOL[1], msg=name)


@pytest.mark.requires_cuda
def test_attention_bwd_kernel_repeatable_and_refusals_on_card(cuda):
    """Two calls give one bit pattern at the train step's shape (the GQA
    sum has a fixed order, no atomics); causal rows that see no key (T <
    S) are refused."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    args = attn_bwd_inputs(np.random.default_rng(3), 16, 10, 1, 256, 256,
                           256, torch.bfloat16, cuda)
    one = flash_attention_bwd_cuda(*args)
    two = flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    q, k, v, do = attn_bwd_inputs(np.random.default_rng(4), 1, 2, 2, 100, 50,
                                  64, torch.float32, cuda)
    with pytest.raises(ValueError, match="see no key"):
        flash_attention_bwd_cuda(q, k, v, do, causal=True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("parts", [1, 2, 5, 10])
def test_attention_bwd_kernel_bf16_parts_on_card(cuda, parts):
    """The GQA sum over every part count of ten query heads on one key
    head (one part: the group inside a block; more: f32 partial sums
    added by a third launch), at the train step's shape and the bf16
    tolerance, each twice bitwise equal."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = attn_bwd_inputs(np.random.default_rng(7), 4, 10, 1, 256,
                                  256, 256, torch.bfloat16, cuda)
    got = flash_attention_bwd_cuda(q, k, v, do, parts=parts)
    again = flash_attention_bwd_cuda(q, k, v, do, parts=parts)
    torch.cuda.synchronize()
    want = tref.attention_bwd_ref(q, k, v, do)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.equal(g, g2), name
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=BF16_ATTN_TOL[0],
                                   rtol=BF16_ATTN_TOL[1], msg=name)


@pytest.mark.requires_cuda
def test_attention_bwd_kernel_bf16_refuses_unaligned_rows(cuda):
    """No fallback to the CUDA cores: bf16 data off 16-byte alignment, or
    a row stride off a multiple of 8 elements, raises."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    x = torch.zeros(1, 1, 9 * 64 + 4, dtype=torch.bfloat16, device=cuda)
    q = x[..., 4:].view(1, 1, 9, 64)           # 8 bytes past 16-byte alignment
    ok = torch.zeros(1, 1, 9, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_cuda(q, ok, ok, ok)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_cuda(ok, ok, ok, q)
    rows = torch.zeros(1, 1, 9, 68, dtype=torch.bfloat16,
                       device=cuda)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_cuda(ok, rows, ok, ok)


@pytest.mark.requires_cuda
def test_attention_fn_bf16_copies_unaligned_do_on_card(cuda):
    """``ops.AttentionFn.backward`` hands the bf16 kernel a dense copy of
    a gradient whose data sits off 16-byte alignment."""
    from repro_torch.kernels import ops
    q, k, v, do = attn_bwd_inputs(np.random.default_rng(9), 1, 2, 1, 64, 64,
                                  64, torch.bfloat16, cuda)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = ops.attention(*leaves, causal=True)
    flat = torch.zeros(do.numel() + 4, dtype=torch.bfloat16, device=cuda)
    odd = flat[4:].view(do.shape)              # 8 bytes past alignment
    odd.copy_(do)
    got = torch.autograd.grad(out, leaves, odd)
    want = tref.attention_bwd_ref(q, k, v, do, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=BF16_ATTN_TOL[0],
                                   rtol=BF16_ATTN_TOL[1])


def close_rglru_bwd(got, want, h):
    """db and dh0 (the reverse recurrence's g) within 1e-5; da = g h_{t-1}
    carries g's 1e-5 times |h|, so its atol is 1e-5 x max(1, max |h|)
    (at a = 1 and 0.9999 over 100 unit steps |h| reaches 27, and the plain
    f32 version's own da lies 1.19x of a plain 1e-5 from f64's)."""
    atol = 1e-5 * max(1.0, float(h.abs().max()))
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        torch.testing.assert_close(g, w, atol=atol if name == "da" else 1e-5,
                                   rtol=1e-5, msg=name)


def rglru_bwd_case(rng, B, T, D, device, a_val=None, scaled=False):
    """(a, h, h0, dh, dh_T): the forward's inputs, its plain output h and
    random output gradients (scaled as b when ``scaled``)."""
    a, b, h0 = rglru_inputs(rng, B, T, D, device, a_val, scaled)
    h, _ = tref.rglru_ref(a, b, h0)
    dh = torch.as_tensor(randn(rng, (B, T, D)), device=device)
    if scaled:
        dh = torch.sqrt(1 - a * a) * dh
    return a, h, h0, dh, torch.as_tensor(randn(rng, (B, D)), device=device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,D", RGLRU_SHAPES + RGLRU_CARD_SHAPES)
def test_rglru_bwd_kernel_on_card(cuda, B, T, D):
    """da, db, dh0 against the step-by-step reverse recurrence
    (``close_rglru_bwd``'s tolerances)."""
    from repro_torch.kernels.rglru_scan import rglru_bwd_cuda
    args = rglru_bwd_case(np.random.default_rng(T + D + 1), B, T, D, cuda)
    got = rglru_bwd_cuda(*args)
    torch.cuda.synchronize()
    close_rglru_bwd(got, tref.rglru_bwd_ref(*args), args[1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("a_val", [0.0, 1.0, 0.9999])
@pytest.mark.parametrize("T,D,scaled", [(100, 64, False), (100, 37, False),
                                        (3072, 64, True)])
def test_rglru_bwd_kernel_extreme_a_on_card(cuda, a_val, T, D, scaled):
    """a = 0, 1 and 0.9999, as the forward's case: unit output gradients
    over 100 steps, and gradients scaled by sqrt(1 - a^2) over 3072."""
    from repro_torch.kernels.rglru_scan import rglru_bwd_cuda
    args = rglru_bwd_case(np.random.default_rng(19), 2, T, D, cuda, a_val,
                          scaled)
    got = rglru_bwd_cuda(*args)
    torch.cuda.synchronize()
    close_rglru_bwd(got, tref.rglru_bwd_ref(*args), args[1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,D", [(16, 256, 2560), (2, 257, 37)])
def test_rglru_bwd_kernel_repeatable_on_card(cuda, B, T, D):
    from repro_torch.kernels.rglru_scan import rglru_bwd_cuda
    args = rglru_bwd_case(np.random.default_rng(6), B, T, D, cuda)
    one, two = rglru_bwd_cuda(*args), rglru_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.requires_cuda
def test_kernel_outputs_carry_gradients_on_card(cuda):
    """``ops.attention``, ``ops.rglru`` and ``ops.wkv`` on CUDA tensors
    give the plain versions' gradients (their kernels' outputs once had
    no grad_fn, so autograd dropped what flowed through them); the FL
    kernels raise under grad instead of returning outputs autograd would
    treat as constants."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(8)
    q, k, v, do = attn_bwd_inputs(rng, 2, 10, 1, 64, 64, 256, torch.float32,
                                  cuda)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = ops.attention(*leaves, causal=True, window=16)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    want = tref.attention_bwd_ref(q, k, v, do, causal=True, window=16)
    for g, w in zip(got, want):
        assert float(g.abs().max()) > 0
        torch.testing.assert_close(g, w, atol=3e-5, rtol=1e-4)

    a, b, h0 = rglru_inputs(rng, 2, 100, 64, cuda)
    leaves = [x.detach().requires_grad_(True) for x in (a, b, h0)]
    h, hT = ops.rglru(*leaves)
    dh = torch.as_tensor(randn(rng, (2, 100, 64)), device=cuda)
    dT = torch.as_tensor(randn(rng, (2, 64)), device=cuda)
    got = torch.autograd.grad((h, hT), leaves, (dh, dT))
    with torch.enable_grad():
        plain = [x.detach().requires_grad_(True) for x in (a, b, h0)]
        want = torch.autograd.grad(tref.rglru_ref(*plain), plain, (dh, dT))
    for g, w in zip(got, want):
        assert float(g.abs().max()) > 0
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)

    r = torch.randn(1, 16, 2, 64, device=cuda, requires_grad=True)
    w = torch.rand(1, 16, 2, 64, device=cuda) * 0.5 + 0.4
    u, s0 = torch.zeros(2, 64, device=cuda), torch.zeros(1, 2, 64, 64,
                                                         device=cuda)
    y, _ = ops.wkv(r, r.detach(), r.detach(), w, u, s0)
    assert y.grad_fn is not None
    dy = torch.randn_like(y)
    got, = torch.autograd.grad(y, r, dy)
    want = tref.wkv_bwd_ref(r.detach(), r.detach(), r.detach(), w, u, s0,
                            dy)[0]
    assert float(got.abs().max()) > 0
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)
    with torch.no_grad():
        ops.wkv(r, r, r, w, u, s0)
    h, lg, lab = to_torch(psg_inputs(32, 120, 10, 0), cuda)
    with pytest.raises(NotImplementedError, match="persample_gradnorm"):
        ops.persample_gradnorm(h.requires_grad_(True), lg, lab)
    p_sum, p_dev, gd, cw, sizes = to_torch(wemd_inputs(2, 16, 10, 5, 0), cuda)
    for op in (ops.wemd_add, ops.wemd_swap):
        with pytest.raises(NotImplementedError, match="wemd"):
            op(p_sum, p_dev.requires_grad_(True), gd, cw, sizes)


# K4-bwd at the LM zoo's train shapes: 8 silos x 2 sequences x 256 tokens
# (B = 16, S = 256), so ``gqa_parts`` picks the train step's part counts
# (7 for qwen2-7b's group 7 on 4 key heads, 2 for qwen3-moe's group 16, 1
# elsewhere): groups 7 (qwen2-7b; yi-34b and arctic-480b on 8 key heads),
# 16 (qwen3-moe-235b-a22b) and 4 (llama-3.2-vision-11b's self layers),
# musicgen-large's hd 64 with 32 heads on 32, llama-vision's cross
# attention of 256 queries over 1601 encoder keys (a key tile 1 key deep),
# non-causal, and gemma3-27b's local layers at S = T = 2048 (its window of
# 1024 never bites at 256).  B, H, KV, S, T, hd, causal, window.
ZOO_ATTN_BWD_CASES = [(16, 28, 4, 256, 256, 128, True, 0),
                      (16, 56, 8, 256, 256, 128, True, 0),
                      (16, 64, 4, 256, 256, 128, True, 0),
                      (16, 32, 8, 256, 256, 128, True, 0),
                      (16, 32, 32, 256, 256, 64, True, 0),
                      (16, 32, 8, 256, 1601, 128, False, 0),
                      (1, 32, 16, 2048, 2048, 128, True, 1024)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window", ZOO_ATTN_BWD_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_bwd_kernel_zoo_train_shapes_on_card(cuda, B, H, KV, S, T,
                                                       hd, causal, window,
                                                       dtype):
    """dq, dk, dv at the zoo's train shapes against autograd of the plain
    version, through the model's [B, S, H, hd] strides: bf16 at
    ``BF16_ATTN_TOL``, f32 at atol 3e-5 / rtol 1e-4; a second call
    bitwise equal."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    dt = getattr(torch, dtype)
    q, k, v, do = attn_bwd_inputs(np.random.default_rng(H + T + hd + window),
                                  B, H, KV, S, T, hd, dt, cuda)
    got = flash_attention_bwd_cuda(q, k, v, do, causal=causal, window=window)
    again = flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    want = tref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    tol = BF16_ATTN_TOL if dt == torch.bfloat16 else (3e-5, 1e-4)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert g.dtype == dt and torch.equal(g, g2), name
        torch.testing.assert_close(g.float(), w.float(), atol=tol[0],
                                   rtol=tol[1], msg=name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_backward_repeatable_on_card(cuda, dtype):
    """The MoE layer's forward and backward twice on the card, at 2048
    tokens over 16 experts of top-4 (empty slots, and tokens dropped at
    capacity factor 0.5): every gradient bitwise equal, and within 1e-4
    relative L2 of the same layer's f32 gradients on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(),
                              num_experts=16, experts_per_token=4,
                              capacity_factor=0.5)
    dt = getattr(torch, dtype)
    params = M.moe_params_init(torch.Generator().manual_seed(0), cfg,
                               torch.float32)
    x = torch.as_tensor(randn(np.random.default_rng(5),
                              (4, 512, cfg.d_model)))
    dy = torch.as_tensor(randn(np.random.default_rng(6),
                               (4, 512, cfg.d_model)))

    def grads(dev, dtype):
        leaves = {k: v.detach().to(dev, dtype if v.dim() == 3 else
                                    v.dtype).requires_grad_(True)
                  for k, v in params.items() if not isinstance(v, dict)}
        p = dict(params, **leaves)
        p["shared"] = {k: v.to(dev, dtype) for k, v in
                       params["shared"].items()}
        xs = x.to(dev, dtype).requires_grad_(True)
        with torch.enable_grad():
            y, aux = M.moe_ffn(p, cfg, xs)
            out = torch.autograd.grad((y, aux), [xs, *leaves.values()],
                                      (dy.to(dev, dtype),
                                       torch.ones((), device=dev)))
        return [g.float().cpu() for g in out]

    one, two = grads(cuda, dt), grads(cuda, dt)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    if dt == torch.float32:
        for g, w in zip(one, grads("cpu", torch.float32)):
            assert float((g - w).norm() / w.norm()) <= 1e-4


# K4 and K4-bwd at a query offset: under context parallelism a rank holds
# the queries [a, b) of S over all T = S keys and runs the kernel at
# q_offset = a.  One card cannot run two shards, so each slice is run
# alone and held to rows a:b of the plain version's full attention (the
# backward to the plain version at the same offset).  Slices whose causal
# edge cuts a 64-key tile mid-way, and gemma3's window of 1024 cut inside
# a tile.  B, H, KV, S, hd, window, slices.
Q_OFFSET_CASES = [(1, 14, 2, 600, 128, 0,                 # qwen2-7b's
                   [(0, 128), (130, 300), (300, 600), (37, 101)]),
                  (1, 4, 2, 1300, 128, 1024,               # gemma3-27b's
                   [(0, 200), (200, 650), (650, 1300)]),
                  (2, 10, 1, 300, 256, 0, [(0, 100), (100, 300)])]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KV,S,hd,window,slices", Q_OFFSET_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_kernels_query_offset_on_card(cuda, B, H, KV, S, hd,
                                                window, slices, dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    dt = getattr(torch, dtype)
    atol, rtol = BF16_ATTN_TOL if dt == torch.bfloat16 else (3e-5, 1e-4)
    q, k, v, do = attn_bwd_inputs(np.random.default_rng(S + hd), B, H, KV,
                                  S, S, hd, dt, cuda)
    full = tref.attention_ref(q, k, v, causal=True, window=window)
    for a, b in slices:
        qs, dos = q[:, :, a:b], do[:, :, a:b]
        out = flash_attention_cuda(qs, k, v, causal=True, window=window,
                                   q_offset=a)
        got = flash_attention_bwd_cuda(qs, k, v, dos, causal=True,
                                       window=window, q_offset=a)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), full[:, :, a:b].float(),
                                   atol=atol, rtol=rtol)
        want = tref.attention_bwd_ref(qs, k, v, dos, causal=True,
                                      window=window, q_offset=a)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                       rtol=rtol, msg=name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_kernels_default_offset_is_bitwise_on_card(cuda, dtype):
    """q_offset = T - S is the call without it, bit for bit (T > S);
    a negative offset is refused by the backward."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    B, H, KV, S, T, hd = 1, 4, 2, 100, 300, 128
    q, k, v, do = attn_bwd_inputs(np.random.default_rng(9), B, H, KV, S, T,
                                  hd, getattr(torch, dtype), cuda)
    assert torch.equal(flash_attention_cuda(q, k, v, window=64),
                       flash_attention_cuda(q, k, v, window=64,
                                            q_offset=T - S))
    one = flash_attention_bwd_cuda(q, k, v, do, window=64)
    two = flash_attention_bwd_cuda(q, k, v, do, window=64, q_offset=T - S)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    with pytest.raises(ValueError, match="see no key"):
        flash_attention_bwd_cuda(q, k, v, do, q_offset=-1)


# Latent attention's head pair: q and k at 192 (nope 128 | rope 64), v at
# 128, the scale 1/sqrt(192).  B, H, S, T, dtype: off the kernels' tiles,
# T > S (queries right-aligned), and in bf16 the cell's 4096 tokens.
MLA_CASES = [(1, 2, 257, 257, "bfloat16"), (2, 3, 100, 300, "bfloat16"),
             (1, 16, 4096, 4096, "bfloat16"), (1, 2, 257, 257, "float32"),
             (2, 3, 100, 300, "float32")]


def mla_inputs(rng, B, H, S, T, dtype, device):
    """q [B,H,S,192], k [B,H,T,192], v [B,H,T,128] and dO [B,H,S,128] as
    the model lays them out: v a view of the [k_nope | v] projection."""
    q = torch.as_tensor(randn(rng, (B, S, H, 192)), device=device)
    kv = torch.as_tensor(randn(rng, (B, T, H, 256)), device=device)
    kr = torch.as_tensor(randn(rng, (B, T, 1, 64)), device=device)
    do = torch.as_tensor(randn(rng, (B, S, H, 128)), device=device)
    q, kv, kr, do = (x.to(dtype) for x in (q, kv, kr, do))
    k = torch.cat([kv[..., :128], kr.expand(B, T, H, 64)], dim=-1)
    return [x.transpose(1, 2) for x in (q, k, kv[..., 128:], do)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,S,T,dtype", MLA_CASES)
def test_attention_kernels_mla_pair_on_card(cuda, B, H, S, T, dtype):
    """K4 and K4-bwd at (192, 128) against the plain version: bf16 at
    ``BF16_ATTN_TOL``, f32 at atol 3e-5 / rtol 1e-4; the launches counted
    with v's shape; two backward calls bitwise equal."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    dt = getattr(torch, dtype)
    q, k, v, do = mla_inputs(np.random.default_rng(S + T), B, H, S, T, dt,
                             cuda)
    tol = BF16_ATTN_TOL if dt == torch.bfloat16 else (3e-5, 1e-4)
    common.reset_launches()
    out = flash_attention_cuda(q, k, v)
    got = flash_attention_bwd_cuda(q, k, v, do)
    again = flash_attention_bwd_cuda(q, k, v, do)
    torch.cuda.synchronize()
    assert out.shape == (B, H, S, 128) and out.dtype == dt
    assert common.SHAPES["attention"] == {
        (tuple(q.shape), tuple(k.shape), (1, 0), tuple(v.shape)): 1}
    assert common.LAUNCHES["attention_bwd"] == 2
    torch.testing.assert_close(out.float(), tref.attention_ref(q, k, v)
                               .float(), atol=tol[0], rtol=tol[1])
    want = tref.attention_bwd_ref(q, k, v, do)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert g.shape == w.shape and torch.equal(g, g2), name
        torch.testing.assert_close(g.float(), w.float(), atol=tol[0],
                                   rtol=tol[1], msg=name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("counts", [[3000, 2500, 4000, 0, 3100, 2900, 3072, 1],
                                    [0, 0, 0, 0, 0, 0, 0, 0],
                                    [24576, 0, 0, 0, 0, 0, 0, 0]])
def test_grouped_products_on_card(cuda, counts):
    """The held experts' grouped products (``moe.grouped_mm``, bf16) and
    their backward against ``torch.bmm`` of each expert's rows, at the
    cell's widths (d 2048, d_ff 1408, 8 experts; an expert with no row,
    all rows on one expert); rows past the runs never reach a gradient,
    even holding NaN."""
    from repro_torch.models.moe import grouped_mm
    rng = np.random.default_rng(len(counts) + sum(counts))
    d, n, E = 2048, 1408, len(counts)
    N = 32768
    x = torch.as_tensor(randn(rng, (N, d)), device=cuda).to(torch.bfloat16)
    w = torch.as_tensor(randn(rng, (E, d, n), d ** -0.5),
                        device=cuda).to(torch.bfloat16)
    offs = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=cuda)
    tot = int(sum(counts))
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = grouped_mm(xl, wl, offs)
    g = torch.as_tensor(randn(rng, (N, n)), device=cuda).to(torch.bfloat16)
    g[tot:] = float("nan")
    out.backward(g)
    torch.cuda.synchronize()
    lo = 0
    for e, c in enumerate(counts):
        xe = x[lo:lo + c].float().requires_grad_(True)
        we = w[e].float().requires_grad_(True)
        ye = torch.bmm(xe[None], we[None])[0]
        ye.backward(g[lo:lo + c].float())
        torch.testing.assert_close(out[lo:lo + c].float(), ye, atol=2e-2,
                                   rtol=1e-2)
        torch.testing.assert_close(xl.grad[lo:lo + c].float(), xe.grad,
                                   atol=2e-2, rtol=1e-2)
        torch.testing.assert_close(wl.grad[e].float(), we.grad,
                                   atol=1e-1 + 1e-2 * float(
                                       we.grad.abs().max()), rtol=1e-2)
        lo += c
    assert torch.isfinite(wl.grad).all()


# K8, the held-expert MoE's dispatch and combine, at a cut of the
# moonlight-silos cell's shape: d 2048, k 6, experts 0-7 of 64 held,
# T = 4096 tokens; seeded, none and every assignment held
MOE_ROWS_CASES = ["seeded", "none_held", "all_held"]


def moe_rows_inputs(case, dtype, device, Tn=4096, d=2048):
    """The layout of a routing and the four kernels' inputs; the buffer
    rows at or past n_held hold NaN."""
    from _moe_gather import routing

    from repro_torch.models.moe import held_layout
    gen = torch.Generator().manual_seed(MOE_ROWS_CASES.index(case))
    experts, w = routing(case, Tn, 64, 6, 8, gen, device)
    slot, src, offs, _ = held_layout(experts, 0, 8)
    n = int(offs[-1])

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(device, dtype)
    x, shared, g = rnd(Tn, d), rnd(Tn, d), rnd(Tn, d)
    y_buf, d_xbuf = rnd(Tn * 6, d), rnd(Tn * 6, d)
    y_buf[n:] = float("nan")
    d_xbuf[n:] = float("nan")
    return n, slot, src, offs, w, x, shared, g, y_buf, d_xbuf


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", MOE_ROWS_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_rows_kernels_on_card(cuda, case, dtype):
    """Each entry point against its plain version: bitwise (dw to f32
    rounding of the sum of |g| |y|), two calls bitwise equal, one launch
    each, no NaN from the rows past n_held."""
    from repro_torch.kernels import common
    from repro_torch.kernels import moe_rows as K8
    n, slot, src, offs, w, x, shared, g, y_buf, d_xbuf = moe_rows_inputs(
        case, getattr(torch, dtype), cuda)
    common.reset_launches()
    calls = {"moe_dispatch": lambda: (K8.dispatch_cuda(x, src, offs)[:n],),
             "moe_combine": lambda: (K8.combine_cuda(y_buf, w, slot,
                                                     shared),),
             "moe_combine_bwd": lambda: [
                 o[:n] if i == 0 else o for i, o in enumerate(
                     K8.combine_bwd_cuda(g, y_buf, w, slot))],
             "moe_dispatch_bwd": lambda: (K8.dispatch_bwd_cuda(d_xbuf,
                                                               slot),)}
    got = {name: [o.clone() for o in fn()] for name, fn in calls.items()}
    assert dict(common.LAUNCHES) == {name: 1 for name in calls}
    again = {name: fn() for name, fn in calls.items()}
    d_buf, dw = K8.combine_bwd_ref(g, y_buf, w, slot)
    want = {"moe_dispatch": [K8.dispatch_ref(x, src, offs)[:n]],
            "moe_combine": [K8.combine_ref(y_buf, w, slot, shared)],
            "moe_combine_bwd": [d_buf[:n], dw],
            "moe_dispatch_bwd": [K8.dispatch_bwd_ref(d_xbuf, slot)]}
    mag = K8.combine_bwd_ref(g.abs(), y_buf.abs(), w, slot)[1]
    torch.cuda.synchronize()
    for name in calls:
        for i, (a, b, c) in enumerate(zip(got[name], want[name],
                                          again[name])):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, c) and not a.isnan().any(), name
            if name == "moe_combine_bwd" and i == 1:
                assert bool(((a - b).abs() <= 1e-5 * mag).all()), name
            else:
                assert torch.equal(a, b), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", MOE_ROWS_CASES)
def test_moe_rows_unwritten_rows_never_reach_the_expert_gradients_on_card(
        cuda, case):
    """The held experts' grouped products and their backward (bf16) with
    the rows of x_buf and d_buf past n_held NaN, as K8 leaves them
    unwritten, against the same rows zero-filled, as the gather
    formulation wrote them: the expert weights' gradients and the output
    and input gradient rows below n_held bitwise equal."""
    from repro_torch.models.moe import grouped_mm
    n, slot, src, offs, w, x, shared, g, y_buf, d_xbuf = moe_rows_inputs(
        case, torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(7)
    ws = [(torch.randn(shape, generator=gen) * shape[1] ** -0.5).to(
        cuda, torch.bfloat16) for shape in ((8, 2048, 1408), (8, 2048, 1408),
                                            (8, 1408, 2048))]
    x_buf = x.repeat(6, 1)
    d_buf = y_buf.nan_to_num(0.0)

    def run(fill):
        xb, db = x_buf.clone(), d_buf.clone()
        xb[n:], db[n:] = fill, fill
        xb.requires_grad_(True)
        leaves = [v.clone().requires_grad_(True) for v in ws]
        h = torch.nn.functional.silu(grouped_mm(xb, leaves[0], offs)) \
            * grouped_mm(xb, leaves[1], offs)
        y = grouped_mm(h, leaves[2], offs)
        grads = torch.autograd.grad(y, [xb, *leaves], db)
        return y[:n], grads[0][:n], grads[1:]

    y0, dx0, dw0 = run(0.0)
    y1, dx1, dw1 = run(float("nan"))
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(dx0, dx1)
    for a, b in zip(dw0, dw1):
        assert torch.equal(a, b) and not a.isnan().any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", MOE_ROWS_CASES)
def test_moe_ffn_held_on_card(cuda, case):
    """The held MoE layer on the card (bf16, through K8) against the gather
    formulation: the output and every gradient bitwise but the router's,
    which is held to 1e-5 of its largest entry; two runs bitwise
    equal."""
    import dataclasses

    from _moe_gather import gather_moe_ffn_held

    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(
        get_config("moonlight-16b-a3b").reduced(
            num_experts=64, experts_per_token=6, experts_held=8),
        dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(20 + MOE_ROWS_CASES.index(case))
    p = dict(T._index(T.init(gen, cfg)["blocks"], 0)["layer0"]["ffn"])
    bias = torch.randn(64, generator=gen) * 0.05
    if case != "seeded":
        bias[slice(0, 6) if case == "all_held" else slice(8, 14)] += 9.0
    p["router_bias"] = bias
    x = torch.randn(4, 512, cfg.d_model, generator=gen).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen).to(torch.bfloat16)
    flat = {k: v for k, v in p.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in p["shared"].items()})

    def run(fn):
        ps = {k: v.to(cuda).requires_grad_(v.is_floating_point()
                                           and k != "router_bias")
              for k, v in flat.items()}
        tree = {k: v for k, v in ps.items() if "." not in k}
        tree["shared"] = {k[7:]: v for k, v in ps.items() if "." in k}
        xs = x.to(cuda).requires_grad_(True)
        out = fn(tree, cfg, xs)
        names = [k for k, v in ps.items() if v.requires_grad]
        grads = torch.autograd.grad(out, [xs, *(ps[k] for k in names)],
                                    dy.to(cuda))
        return out, dict(zip(["x", *names], grads))

    common.reset_launches()
    out, grads = run(M.moe_ffn_held)
    assert {k: common.LAUNCHES[k] for k in (
        "moe_dispatch", "moe_combine", "moe_combine_bwd",
        "moe_dispatch_bwd")} == {"moe_dispatch": 1, "moe_combine": 1,
                                 "moe_combine_bwd": 1, "moe_dispatch_bwd": 1}
    out2, grads2 = run(M.moe_ffn_held)
    want, want_g = run(gather_moe_ffn_held)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(out, want)
    for name, gw in want_g.items():
        assert torch.equal(grads[name], grads2[name]), name
        if name == "router":
            torch.testing.assert_close(grads[name], gw, rtol=1e-5,
                                       atol=1e-5 * float(gw.abs().max()))
        else:
            assert torch.equal(grads[name], gw), name
