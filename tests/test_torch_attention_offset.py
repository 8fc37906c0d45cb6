"""K4's query offset on the CPU route: ``ref.attention_ref`` /
``attention_bwd_ref`` / ``ops.attention`` with ``q_offset`` (the key
position of query 0) held to the JAX package's attention over explicit
positions (``repro.models.layers._mask_bias`` with ``q_pos``, then
``_attend``), and to jax.vjp of it; the default (T - S) is the call
without an offset bit for bit.  A shard [a, b) of the queries over all
keys, at q_offset = a + T - S, is what each rank runs under context
parallelism.  f32, atol 1e-5 / rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# B, H, KV, S, T, hd, causal, window, query slices [a, b)
CASES = [(2, 4, 2, 40, 40, 32, True, 0, [(0, 16), (16, 40), (7, 23)]),
         (1, 6, 2, 48, 48, 16, True, 12, [(0, 20), (20, 48), (30, 31)]),
         (1, 2, 1, 24, 40, 32, True, 0, [(0, 8), (8, 24)]),      # T > S
         (1, 4, 4, 30, 30, 16, False, 0, [(3, 17)])]


def inputs(seed, B, H, KV, S, T, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, T, hd)).astype(np.float32),
            rng.normal(size=(B, KV, T, hd)).astype(np.float32),
            rng.normal(size=(B, H, S, hd)).astype(np.float32))


def jax_attention(q, k, v, q_pos, causal, window):
    """The reference's attention at explicit positions: q [B,H,S,hd],
    k/v [B,KV,T,hd] -> [B,H,S,hd]."""
    H, T = q.shape[1], k.shape[2]
    bias = JL._mask_bias(q_pos, jnp.arange(T), window, causal)
    out = JL._attend(q.transpose(0, 2, 1, 3),
                     JL._expand_kv(k.transpose(0, 2, 1, 3), H),
                     JL._expand_kv(v.transpose(0, 2, 1, 3), H), bias)
    return out.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", CASES)
def test_query_offset_matches_reference_positions(case):
    B, H, KV, S, T, hd, causal, window, slices = case
    q, k, v, do = inputs(S + T + hd, B, H, KV, S, T, hd)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    full = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(full, tref.attention_ref(
        tq, tk, tv, causal=causal, window=window, q_offset=T - S))
    for a, b in slices:
        off = a + T - S
        got = tref.attention_ref(tq[:, :, a:b], tk, tv, causal=causal,
                                 window=window, q_offset=off)
        pos = jnp.arange(a, b) + (T - S)
        want = jax_attention(q[:, :, a:b], k, v, pos, causal, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), full[:, :, a:b].numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert torch.equal(got, ops.attention(
            tq[:, :, a:b], tk, tv, causal=causal, window=window,
            q_offset=off))
        # the backward's plain version against jax.vjp of the reference
        grads = tref.attention_bwd_ref(tq[:, :, a:b], tk, tv,
                                       tdo[:, :, a:b], causal=causal,
                                       window=window, q_offset=off)
        _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention(
            q_, k_, v_, pos, causal, window), q[:, :, a:b], k, v)
        for name, g, w in zip(("dq", "dk", "dv"), grads,
                              vjp(do[:, :, a:b])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


def test_default_offset_backward_is_bitwise_the_call_without_it():
    B, H, KV, S, T, hd = 1, 4, 2, 24, 40, 32
    q, k, v, do = (torch.as_tensor(x)
                   for x in inputs(0, B, H, KV, S, T, hd))
    one = tref.attention_bwd_ref(q, k, v, do, causal=True, window=8)
    two = tref.attention_bwd_ref(q, k, v, do, causal=True, window=8,
                                 q_offset=T - S)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
