"""Paper CNN and Eq. 10-12 estimators: the port against the JAX
reference from converted params (atol 1e-5 / rtol 1e-4, f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as JCNNConfig
from repro.configs.paper_cnn import PAPER_CNN_CIFAR10 as J_PAPER
from repro.core import estimation as JE
from repro.fl.rounds import _cnn_features_logits as j_features_logits
from repro.models import build_model as j_build
from repro_torch import convert
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.configs.paper_cnn import PAPER_CNN_CIFAR10
from repro_torch.core import estimation as TE
from repro_torch.fl.rounds import _cnn_features_logits as t_features_logits
from repro_torch.models.registry import build_model

ATOL, RTOL = 1e-5, 1e-4
MICRO = dict(name="micro-cnn", kind="paper_cnn", num_classes=2,
             image_size=8, dropout=False, width=0.25)


def pair(micro: bool):
    if micro:
        return JCNNConfig(**MICRO), CNNConfig(**MICRO)
    return (dataclasses.replace(J_PAPER, dropout=False),
            dataclasses.replace(PAPER_CNN_CIFAR10, dropout=False))


def setup(micro, batch, seed=0):
    jcfg, tcfg = pair(micro)
    jm, tm = j_build(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.key(seed))
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, tcfg.image_size, tcfg.image_size,
                         3)).astype(np.float32)
    y = rng.integers(0, tcfg.num_classes, batch).astype(np.int32)
    return jm, tm, jp, tp, x, y


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("micro,batch", [(True, 6), (False, 2)])
def test_forward_logits_and_features(micro, batch):
    """The full-width case (32x32, fc1 over 8*8*64 = 4096 rows) fails if
    fc1's rows are not permuted from the JAX (h, w, c) flatten order."""
    jm, tm, jp, tp, x, y = setup(micro, batch)
    close(tm.forward(tp, {"images": torch.from_numpy(x)}),
          jm.forward(jp, {"images": jnp.asarray(x)}))
    jf, jl = j_features_logits(jp, jm.cfg, jnp.asarray(x))
    tf, tl = t_features_logits(tp, tm.cfg, torch.from_numpy(x))
    close(tf, jf)
    close(tl, jl)


def test_loss_and_grads_micro():
    jm, tm, jp, tp, x, y = setup(True, 8, seed=1)
    jb = {"images": jnp.asarray(x), "labels": jnp.asarray(y)}
    tb = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)}
    (jl, _), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
    tg, (tl, metrics) = torch.func.grad_and_value(
        tm.loss_fn, has_aux=True)(tp, tb)
    close(tl, jl)
    tg_j = convert.params_to_jax(tg, tm.cfg)
    for k in jg:
        close(torch.from_numpy(tg_j[k]), jg[k])
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0


def test_params_roundtrip_and_init_shapes():
    jm, tm, jp, tp, x, y = setup(False, 1)
    back = convert.params_to_jax(tp, tm.cfg)
    for k in jp:
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))
    init = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert tp["c1"].shape == (32, 3, 3, 3) and tp["fc1"].shape == (4096, 120)


def test_dropout_masks_drive_the_forward():
    tm = build_model(PAPER_CNN_CIFAR10.reduced())
    assert tm.dropout_shapes(4) == ()
    tm = build_model(PAPER_CNN_CIFAR10)
    shapes = tm.dropout_shapes(4)
    assert shapes == ((4, 32, 16, 16), (4, 64, 8, 8))
    p = tm.init(torch.Generator().manual_seed(0))
    x = {"images": torch.randn(4, 32, 32, 3)}
    keep = tuple(torch.ones(s, dtype=torch.bool) for s in shapes)
    assert not torch.equal(tm.forward(p, x, keep), tm.forward(p, x))
    drop = tuple(torch.zeros(s, dtype=torch.bool) for s in shapes)
    out = tm.forward(p, x, drop)
    torch.testing.assert_close(out, p["b2"].expand_as(out) + torch.relu(
        p["b1"]) @ p["fc2"])


@pytest.mark.parametrize("B,d,C", [(32, 120, 10), (64, 16, 5)])
def test_sigma_lastlayer_both_branches(B, d, C):
    rng = np.random.default_rng(B + d)
    h = rng.normal(size=(B, d)).astype(np.float32)
    logits = rng.normal(size=(B, C)).astype(np.float32)
    y = rng.integers(0, C, B).astype(np.int32)
    th, tl, ty = map(torch.from_numpy, (h, logits, y))
    want = JE.sigma_hat_lastlayer(jnp.asarray(h), jnp.asarray(logits),
                                  jnp.asarray(y))
    close(TE.sigma_hat_lastlayer(th, tl, ty), want)
    close(TE.sigma_hat_lastlayer(th, tl, ty, use_kernel=True), want)
    # a leading device axis gives every device's sigma in one call
    stacked = TE.sigma_hat_lastlayer(th[None].expand(3, -1, -1),
                                     tl[None].expand(3, -1, -1),
                                     ty[None].expand(3, -1))
    close(stacked, np.full(3, float(want)))


def test_sigma_exact_matches_reference():
    rng = np.random.default_rng(0)
    W = (rng.normal(size=(12, 4)) * 0.2).astype(np.float32)
    h = rng.normal(size=(32, 12)).astype(np.float32)
    y = rng.integers(0, 4, 32).astype(np.int32)

    def j_loss(params, ex):
        hi, yi = ex
        return -jax.nn.log_softmax(hi @ params)[yi]

    def t_loss(params, ex):
        hi, yi = ex
        onehot = torch.arange(4) == yi
        return -torch.where(onehot, torch.log_softmax(hi @ params, -1),
                            0.0).sum()

    want = JE.sigma_hat_exact(j_loss, jnp.asarray(W),
                              (jnp.asarray(h), jnp.asarray(y)))
    got = TE.sigma_hat_exact(t_loss, torch.from_numpy(W),
                             (torch.from_numpy(h), torch.from_numpy(y)))
    close(got, want)
    close(TE.sigma_hat_lastlayer(torch.from_numpy(h),
                                 torch.from_numpy(h @ W),
                                 torch.from_numpy(y)), want, atol=1e-4)


def test_g_hat_and_centered_norms_match_reference():
    rng = np.random.default_rng(3)
    C, U = 4, 6
    grads = rng.normal(size=(U, 9)).astype(np.float32)
    alphas = np.ones(U) / U
    p_dev = rng.dirichlet(np.ones(C), size=U)
    gd = np.ones(C) / C
    jg = [{"w": jnp.asarray(g)} for g in grads]
    tg = [{"w": torch.from_numpy(g)} for g in grads]
    np.testing.assert_allclose(
        TE._grad_deviation_norms(tg, alphas),
        JE._grad_deviation_norms(jg, alphas), rtol=1e-6)
    assert np.isclose(TE.g_hat(tg, alphas, p_dev, gd),
                      JE.g_hat(jg, alphas, p_dev, gd), rtol=1e-6)
    dc = rng.integers(0, C, U)
    np.testing.assert_allclose(
        TE.g_hat_per_class(tg, alphas, dc, p_dev, gd, C),
        JE.g_hat_per_class(jg, alphas, dc, p_dev, gd, C), rtol=1e-6)
    assert TE.sigma_hat_global(np.arange(3.0), np.ones(3) / 3) == \
        JE.sigma_hat_global(np.arange(3.0), np.ones(3) / 3)
