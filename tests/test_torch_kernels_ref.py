"""The port's kernels against the reference: the plain PyTorch versions
(what the CPU path runs) match ``repro.kernels.ref`` and the
interpret-mode Pallas kernels at ``tests/test_kernels.py``'s shapes and
tolerances.  The hand-written kernels themselves are held against these
plain versions on the card in ``tests/test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.persample_gradnorm import persample_gradnorm_pallas
from repro.kernels.wemd_swap import wemd_add_pallas, wemd_swap_pallas
from repro_torch.kernels import ops
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


def to_jax(args):
    return [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("B,V,C", SWAP_SHAPES)
def test_wemd_swap_plain_matches_reference(B, V, C):
    args = wemd_inputs(B, V, C, min(5, V), seed=B * 1000 + V)
    got = tref.wemd_swap_ref(*to_torch(args)).numpy()
    np.testing.assert_allclose(got, jref.wemd_swap_ref(*to_jax(args)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got, wemd_swap_pallas(*to_jax(args), interpret=True),
        atol=1e-5, rtol=1e-5)
    # the CPU route of the dispatcher is the plain version
    np.testing.assert_array_equal(ops.wemd_swap(*to_torch(args)).numpy(),
                                  got)


@pytest.mark.parametrize("B,V,C", ADD_SHAPES)
def test_wemd_add_plain_matches_reference(B, V, C):
    args = wemd_inputs(B, V, C, min(3, V), seed=B * 1000 + V + 1)
    got = tref.wemd_add_ref(*to_torch(args)).numpy()
    np.testing.assert_allclose(got, jref.wemd_add_ref(*to_jax(args)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got, wemd_add_pallas(*to_jax(args), interpret=True),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ops.wemd_add(*to_torch(args)).numpy(), got)


def test_wemd_ops_cast_f64_inputs_to_f32():
    """The scheduler hands the dispatcher f64 state; both routes compute
    the f32 function the Pallas wrappers compute."""
    args = wemd_inputs(2, 19, 11, 4, seed=3)
    a64 = [torch.as_tensor(a, dtype=torch.float64) for a in args]
    out = ops.wemd_swap(*a64)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), wemd_swap_pallas(*to_jax(args), interpret=True),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,d,C", PSG_SHAPES)
def test_persample_gradnorm_plain_matches_reference(B, d, C):
    args = psg_inputs(B, d, C, seed=B + d)
    s, gi = tref.persample_gradnorm_ref(*to_torch(args))
    sr, gr = jref.persample_gradnorm_ref(*to_jax(args))
    sp, gp = persample_gradnorm_pallas(*to_jax(args), interpret=True)
    for want_s, want_g in ((sr, gr), (sp, gp)):
        np.testing.assert_allclose(float(s), float(want_s), atol=1e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(gi.numpy(), want_g, atol=1e-2,
                                   rtol=1e-3)


def test_persample_gradnorm_batched_plain_is_per_device():
    """The [V, B, d] entry equals V single-device calls."""
    per = [psg_inputs(32, 120, 10, seed=v) for v in range(5)]
    stacked = [np.stack(x) for x in zip(*per)]
    s, gi = ops.persample_gradnorm(*to_torch(stacked))
    assert s.shape == (5,) and gi.shape == (5, 32)
    for v, args in enumerate(per):
        s1, g1 = ops.persample_gradnorm(*to_torch(args))
        torch.testing.assert_close(s[v], s1, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(gi[v], g1, atol=1e-5, rtol=1e-5)
