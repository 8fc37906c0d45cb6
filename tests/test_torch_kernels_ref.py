"""The port's kernels against the reference: the plain PyTorch versions
(what the CPU path runs) match ``repro.kernels.ref`` and the
interpret-mode Pallas kernels at ``tests/test_kernels.py``'s shapes and
tolerances.  The hand-written kernels themselves are held against these
plain versions on the card in ``tests/test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_psg import (psg_aligned, psg_resnet_head, round_tolerance,
                        sigma_f64)

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


@pytest.mark.parametrize("kind", ["add", "swap"])
def test_wemd_ops_cast_f64_inputs_to_f32(kind):
    """The scheduler hands the dispatcher f64 state; both routes compute
    the f32 function the Pallas wrappers compute."""
    op, pallas = ((ops.wemd_add, wemd_add_pallas) if kind == "add"
                  else (ops.wemd_swap, wemd_swap_pallas))
    args = wemd_inputs(2, 19, 11, 4, seed=3)
    a64 = [torch.as_tensor(a, dtype=torch.float64) for a in args]
    out = op(*a64)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), pallas(*to_jax(args), interpret=True),
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


def psg_tiled(h, logits, labels, kt):
    """The sums of ``csrc/persample_gradnorm.cu`` in plain torch, one
    device: E once, then ||h_i||^2, the columns of H^T E and the squared
    deviations h_ik e_ic - gbar_kc from them a feature tile of ``kt``
    columns at a time (the second pass over the rows)."""
    B, d = h.shape
    p = torch.softmax(logits, dim=-1)
    e = p - torch.nn.functional.one_hot(labels.long(), logits.shape[-1])
    hh, dev = torch.zeros(B), torch.zeros(())
    for k0 in range(0, d, kt):
        tile = h[:, k0:k0 + kt]
        hh = hh + (tile * tile).sum(-1)
        gbar = tile.T @ e / B
        dev = dev + ((tile[:, :, None] * e[:, None, :] - gbar) ** 2).sum()
    return torch.sqrt(dev / B), hh * (e * e).sum(-1)


def psg_one_pass(h, logits, labels):
    """The TPU kernel's sums: sqrt(max(mean gi_sq - ||H^T E / B||^2, 0))."""
    p = torch.softmax(logits, dim=-1)
    e = p - torch.nn.functional.one_hot(labels.long(), logits.shape[-1])
    gi_sq = (h * h).sum(-1) * (e * e).sum(-1)
    gb = ((h.T @ e / h.shape[0]) ** 2).sum()
    return torch.sqrt(torch.clamp(gi_sq.mean() - gb, min=0.0))


@pytest.mark.parametrize("kt", [120, 16])
def test_sigma_two_pass_needed(kt):
    """Why the kernel sums sigma over the deviations in a second pass: on
    aligned per-sample gradients (mean ||g_i||^2 / sigma^2 ~ 1e5, as a
    diverging FL round showed on the card) the one-pass f32 sum loses
    three digits, the two passes keep f32's."""
    one_err = []
    for seed in range(3):
        h, lg, y = to_torch([x[0] for x in psg_aligned(1, 32, 120, 10,
                                                       seed)])
        truth = float(sigma_f64(h, lg, y))
        one_err.append(abs(float(psg_one_pass(h, lg, y)) - truth) / truth)
        two = float(psg_tiled(h, lg, y, kt)[0])
        assert abs(two - truth) <= 1e-5 * truth
    assert max(one_err) > 1e-3


def psg_thread_order(h, logits, labels, f64_total):
    """The deviations' sum of ``csrc/persample_gradnorm.cu`` in its order,
    in numpy f32, one device with all of h in one tile: thread t of 256
    owns columns t, t + 256, ..; for each 16-class chunk it walks the
    rows and adds the squares (h_ik e_ic - gbar_kc)^2.  ``f64_total``:
    a row's chunk summed in f32, added to an f64 total (the kernel);
    else every square added to an f32 total."""
    f32 = np.float32
    B, d = h.shape
    C = logits.shape[1]
    z = np.exp(logits - logits.max(1, keepdims=True)).astype(f32)
    e = (z / z.sum(1, keepdims=True)).astype(f32)
    e[np.arange(B), labels] -= f32(1)
    ng = -(h.T @ e).astype(f32) * f32(1.0 / B)
    total = np.zeros(256, np.float64 if f64_total else f32)
    for k0 in range(0, d, 256):
        ks = np.arange(k0, min(k0 + 256, d))
        for c0 in range(0, C, 16):
            for i in range(B):
                row = np.zeros(len(ks), f32)
                for c in range(c0, min(c0 + 16, C)):
                    x = h[i, ks] * e[i, c] + ng[ks, c]
                    if f64_total:
                        row = row + x * x
                    else:
                        total[ks - k0] = total[ks - k0] + x * x
                if f64_total:
                    total[ks - k0] += row
    return np.sqrt(total.astype(np.float64).sum() / B)


def test_sigma_f64_total_needed_at_resnet_head():
    """Why the kernel keeps the deviations' sum in f64: at ResNet18-GN's
    head (d = 512, C = 100) a thread adds 6400 squares, and an f32 total
    of them strays toward the FL round's tolerance against Eq. 10 in f64
    (over it on the card's first ResNet round); f32 sums of a row's 16
    classes added to an f64 total stay far under it."""
    f32_share, f64_share = [], []
    for seed in range(3):
        h, lg, y = (x[0] for x in psg_resnet_head(1, 32, 512, 100, seed))
        truth = sigma_f64(*to_torch([h, lg, y]))
        tol = float(round_tolerance(torch.from_numpy(h), truth))
        for out, f64_total in ((f32_share, False), (f64_share, True)):
            got = psg_thread_order(h, lg, y, f64_total)
            out.append(abs(got - float(truth)) / tol)
    assert max(f32_share) > 0.3
    assert max(f64_share) < 0.03


@pytest.mark.parametrize("B,d,C", PSG_SHAPES + [(32, 120, 10), (33, 37, 10),
                                                (32, 120, 100)])
def test_persample_gradnorm_plan_tiles_d(B, d, C):
    """The kernel's plan: all of h in shared memory at the round's shape,
    column tiles (multiples of 4) where B * d does not fit; with those
    tiles the kernel's sums match the interpret-mode Pallas kernel at
    test_kernels.py's tolerances."""
    from repro_torch.kernels.persample_gradnorm import (MAX_SHARED_BYTES,
                                                         _plan)
    kt, smem = _plan(B, d, C)
    assert smem <= MAX_SHARED_BYTES
    assert kt == d or (kt % 4 == 0 and 4 <= kt < d)
    if (B, d, C) == (32, 120, 10):
        assert kt == d and smem < 48 * 1024
    if (B, d, C) == (100, 512, 100):
        assert kt < d
    args = psg_inputs(B, d, C, seed=B + d + C)
    s, gi = psg_tiled(*to_torch(args), kt)
    sp, gp = persample_gradnorm_pallas(*to_jax(args), interpret=True)
    np.testing.assert_allclose(float(s), float(sp), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(gi.numpy(), gp, atol=1e-2, rtol=1e-3)


def test_persample_gradnorm_plan_refuses_what_does_not_fit():
    from repro_torch.kernels.persample_gradnorm import _plan
    with pytest.raises(ValueError, match="shared memory"):
        _plan(3000, 120, 10)             # logits and E alone: 240 KB


class OnCard(torch.Tensor):
    """A CPU tensor that calls itself a CUDA tensor on device ``card``, so
    that a wrapper's validation runs here; it cannot launch."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return self.card


def on_card(x, card=0):
    y = x.as_subclass(OnCard)
    y.card = card
    return y


def test_persample_gradnorm_wrapper_refuses_bad_inputs_before_launch(
        monkeypatch):
    """CPU, mixed-device, wrong-dtype, non-contiguous, misshapen and empty
    inputs raise ValueError before the kernel is built or launched; f32
    features and logits with int64 or int32 labels reach the launch; no
    device (V = 0) launches nothing."""
    from repro_torch.kernels import persample_gradnorm as K
    from repro_torch.kernels.common import LAUNCHES

    def no_launch():
        raise AssertionError("the kernel was reached")
    monkeypatch.setattr(K, "_launcher", no_launch)
    h, lg, lb = (torch.as_tensor(np.stack([x, x]))
                 for x in psg_inputs(32, 120, 10, seed=1))
    lb64 = lb.long()
    before = LAUNCHES["persample_gradnorm"]
    bad = {"CUDA": (h, lg, lb64),
           "CUDA tensors only": (on_card(h), on_card(lg), lb64),
           "one device": (on_card(h), on_card(lg), on_card(lb64, 1)),
           "f32 features": (on_card(h.double()), on_card(lg),
                            on_card(lb64)),
           "int64 labels": (on_card(h), on_card(lg),
                            on_card(lb.to(torch.int16))),
           "contiguous": (on_card(h), on_card(lg),
                          on_card(lb64.T.contiguous().T)),
           "shape mismatch": (on_card(h), on_card(lg[:1].contiguous()),
                              on_card(lb64)),
           "at least one": (on_card(h[:, :0].contiguous()),
                            on_card(lg[:, :0].contiguous()),
                            on_card(lb64[:, :0].contiguous()))}
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            K.persample_gradnorm_cuda_batched(*args)
    for labels in (lb64, lb):
        with pytest.raises(AssertionError, match="reached"):
            K.persample_gradnorm_cuda_batched(on_card(h), on_card(lg),
                                              on_card(labels))
    sigma, gi_sq = K.persample_gradnorm_cuda_batched(
        *(on_card(x[:0].contiguous()) for x in (h, lg, lb64)))
    assert sigma.shape == (0,) and gi_sq.shape == (0, 32)
    assert LAUNCHES["persample_gradnorm"] == before


def test_rglru_wrapper_refuses_bad_inputs_before_launch(monkeypatch):
    """CPU, mixed-device, wrong-dtype, non-contiguous and misshapen inputs
    raise ValueError before the kernel is built or launched; an empty
    batch launches nothing."""
    from repro_torch.kernels import rglru_scan as K
    from repro_torch.kernels.common import LAUNCHES

    def no_launch():
        raise AssertionError("the kernel was reached")
    monkeypatch.setattr(K, "_launcher", no_launch)
    a, h0 = torch.zeros(2, 9, 37), torch.zeros(2, 37)
    before = LAUNCHES["rglru"]
    bad = {"CUDA": (a, a, h0),
           "CUDA tensors only": (on_card(a), on_card(a), h0),
           "one device": (on_card(a), on_card(a), on_card(h0, 1)),
           "f32": (on_card(a.double()), on_card(a.double()),
                   on_card(h0.double())),
           "contiguous": (on_card(a.transpose(1, 2).contiguous()
                                  .transpose(1, 2)), on_card(a), on_card(h0)),
           "expected": (on_card(a), on_card(a[:, :3].contiguous()),
                        on_card(h0))}
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            K.rglru_cuda(*args)
    with pytest.raises(AssertionError, match="reached"):
        K.rglru_cuda(on_card(a), on_card(a), on_card(h0))
    y, hT = K.rglru_cuda(*(on_card(x[:0]) for x in (a, a, h0)))
    assert y.shape == (0, 9, 37) and hT.shape == (0, 37)
    assert LAUNCHES["rglru"] == before
