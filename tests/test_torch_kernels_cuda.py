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
@pytest.mark.parametrize("B,V,C", SWAP_SHAPES + [(32, 19, 10)])
def test_wemd_swap_kernel_on_card(cuda, B, V, C):
    from repro_torch.kernels.wemd_swap import wemd_swap_triton
    args = to_torch(wemd_inputs(B, V, C, min(5, V), seed=V), cuda)
    out = wemd_swap_triton(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tref.wemd_swap_ref(*args), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,V,C", ADD_SHAPES + [(1, 19, 10)])
def test_wemd_add_kernel_on_card(cuda, B, V, C):
    from repro_torch.kernels.wemd_swap import wemd_add_triton
    args = to_torch(wemd_inputs(B, V, C, min(3, V), seed=V), cuda)
    out = wemd_add_triton(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tref.wemd_add_ref(*args), atol=1e-5,
                               rtol=1e-5)


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
