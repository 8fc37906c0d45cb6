"""ResNet18-GN (CIFAR-100's 100 classes) and the Section IV
instrumentation: the port against the JAX reference.

The model runs at ``RESNET18_GN_CIFAR100.reduced()`` (16x16 images, the
reference's fixed 64-512 channels, 100 classes) from weights converted
from the reference's init, f32 at atol 1e-4 / rtol 1e-3 (as
``tests/test_torch_round.py``); GroupNorm alone at 1e-5.  The trainers
run a micro world (6 devices, all available, batch 4, tau 1) with
``scheduler_backend="numpy"`` on both sides and a payload of 8e7 bits,
at which 2-3 of the 6 devices fit the bandwidth (at the ResNet's own
359 Mbit, one does): masks and iteration counts must be equal, sigmas,
norms and params close, and the port's ``"torch"`` backend bitwise
equal to its ``"numpy"`` one.  The reference trainers are module
fixtures, so each compiles its round core once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.paper_cnn import RESNET18_GN_CIFAR100 as J_RESNET
from repro.core import cgd as jcgd
from repro.data import (sort_and_partition, synthetic_image_dataset,
                        train_test_split)
from repro.fl import FederatedTrainer as JTrainer
from repro.fl import FLConfig as JFLConfig
from repro.fl import MultiCellTrainer as JMultiCell
from repro.fl.rounds import _cnn_features_logits as j_features_logits
from repro.fl.virtual import virtual_step as j_virtual_step
from repro.models import build_model as j_build
from repro.models import cnn as JC
from repro_torch import convert
from repro_torch.configs import CNN_MODELS, RESNET18_GN_CIFAR100, CNNConfig
from repro_torch.core import cgd
from repro_torch.fl import FederatedTrainer, FLConfig, MultiCellTrainer
from repro_torch.fl.multicell import _pad_batches
from repro_torch.fl.rounds import _cnn_features_logits as t_features_logits
from repro_torch.fl.virtual import virtual_step
from repro_torch.models import cnn as C
from repro_torch.models.registry import build_model

ATOL, RTOL = 1e-4, 1e-3
PAYLOAD_BITS = 8e7


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, JAX params, the same params converted)."""
    jm, tm = j_build(J_RESNET.reduced()), build_model(
        RESNET18_GN_CIFAR100.reduced())
    jp = jm.init(jax.random.key(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                                 device="cpu")
    return jm, tm, jp, tp


def images(n, size, seed=0, channels=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, channels)).astype(np.float32)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# the model


def test_registry_and_init(models):
    _, tm, jp, tp = models
    assert set(CNN_MODELS) == {"paper-cnn-cifar10", "resnet18-gn-cifar100"}
    init = tm.init(torch.Generator().manual_seed(0))
    assert init.keys() == tp.keys()
    assert all(init[k].shape == tp[k].shape for k in init)
    assert sum(x.numel() for x in init.values()) == sum(
        x.size for x in jax.tree.leaves(jp))
    assert init["fc"].shape == (512, 100) and "s2b0.conv1" in init
    assert float(init["fc"].std()) == pytest.approx(0.05, rel=0.05)
    assert tm.dropout_shapes(32) == ()      # dropout=True, but no dropout
    with pytest.raises(ValueError, match="unknown CNN kind"):
        build_model(CNNConfig(name="x", kind="vgg", num_classes=10))


def test_features_and_logits_match_reference(models):
    jm, tm, jp, tp = models
    x = images(3, 16)
    close(tm.forward(tp, {"images": torch.from_numpy(x)}),
          jm.forward(jp, {"images": jnp.asarray(x)}))
    jf, jl = j_features_logits(jp, jm.cfg, jnp.asarray(x))
    tf, tl = t_features_logits(tp, tm.cfg, torch.from_numpy(x))
    assert tf.shape == (3, 512) and tl.shape == (3, 100)
    close(tf, jf)
    close(tl, jl)


def test_stride2_block_pads_like_jax(models, monkeypatch):
    """A stride-2 block (3x3 conv and 1x1 projection) on an even 8x8
    input: JAX's SAME pads the 3x3 conv (0, 1).  Symmetric padding
    (``padding=1``) is far off, so this check would catch it."""
    jm, tm, jp, tp = models
    x = images(2, 8, seed=1, channels=64)
    want = JC._block_fwd(jp["s1b0"], jnp.asarray(x), 2, 8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = C._block_fwd(tp, "s1b0", xt, 2, True, 8).permute(0, 2, 3, 1)
    assert got.shape == (2, 4, 4, 128)
    close(got, want)
    monkeypatch.setattr(C, "_conv", lambda x, w, stride=1: F.conv2d(
        x, w, stride=stride, padding=w.shape[-1] // 2))
    bad = C._block_fwd(tp, "s1b0", xt, 2, True, 8).permute(0, 2, 3, 1)
    assert not np.allclose(bad.numpy(), np.asarray(want), atol=ATOL,
                           rtol=RTOL)


def test_groupnorm_matches_reference_under_vmap(recwarn):
    """``_gn`` (NCHW) against the reference's (NHWC) at 1e-5, and under
    ``torch.func.vmap`` with no per-sample fallback warning."""
    rng = np.random.default_rng(2)
    x = (3.0 * rng.normal(size=(4, 2, 6, 6, 64)) + 1.0).astype(np.float32)
    s = rng.normal(size=64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    want = np.stack([np.asarray(JC._gn(jnp.asarray(xi), jnp.asarray(s),
                                       jnp.asarray(b), 8)) for xi in x])
    xt = torch.from_numpy(x).permute(0, 1, 4, 2, 3)
    got = torch.func.vmap(lambda xi: C._gn(xi, torch.from_numpy(s),
                                           torch.from_numpy(b), 8))(xt)
    close(got.permute(0, 1, 3, 4, 2), want, atol=1e-5, rtol=1e-5)
    assert not [w for w in recwarn if "performance drop" in str(w.message)]


def test_weight_conversion_roundtrip_is_exact(models):
    _, tm, jp, tp = models
    back = convert.params_to_jax(tp, tm.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    assert tp["s1b0.conv1"].shape == (128, 64, 3, 3)       # OIHW
    assert tp["s1b0.proj"].shape == (128, 64, 1, 1)
    assert jp["s1b0"]["conv1"].shape == (3, 3, 64, 128)    # HWIO
    again = convert.params_from_jax(back, tm.cfg, device="cpu")
    assert all(torch.equal(again[k], tp[k]) for k in tp)


# ---------------------------------------------------------------------------
# the round, one cell and two


@pytest.fixture(scope="module")
def world(models):
    jm, tm, _, _ = models
    ds = synthetic_image_dataset(num_classes=100, num_per_class=6,
                                 image_size=16, seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 6, 1, np.random.default_rng(0))
    return jm, tm, train, test, parts


def cfg_kw(scheduler, cells=1):
    return dict(num_devices=6, available_prob=1.0, batch_size=4, tau=1,
                eval_every=2, seed=0, scheduler=scheduler, num_cells=cells,
                payload_bits_override=PAYLOAD_BITS)


def recording(base):
    """``base`` that keeps each round's mask, iteration count, Eq. 10
    sigmas and delta norms."""
    class Recording(base):
        def _schedule(self, prob, avail_idx, gains, delta_norms, j):
            sched = super()._schedule(prob, avail_idx, gains, delta_norms,
                                      j)
            self.log.append((sched.mask.copy(), sched.iterations,
                             np.asarray(delta_norms).copy()))
            return sched

        def _post_core(self, prep, dev_losses, sigma_v):
            self.sigmas.append(np.asarray(sigma_v).copy())
            super()._post_core(prep, dev_losses, sigma_v)
    return Recording


def run(trainer, rounds):
    trainer.log, trainer.sigmas = [], []
    recs = [trainer.run_round(j) for j in range(rounds)]
    return recs


@pytest.fixture(scope="module", params=["fedcgd-fscd", "fedcgd-gs"])
def reference_run(request, world):
    """The reference trainer's 3 rounds: (trainer, records)."""
    jm, _, train, test, parts = world
    jt = recording(JTrainer)(jm, train, test, parts, JFLConfig(
        scheduler_backend="numpy", **cfg_kw(request.param)))
    params0 = jax.tree.map(np.asarray, jt.params)
    return request.param, params0, jt, run(jt, 3)


def port_run(world, scheduler, backend, params0):
    _, tm, train, test, parts = world
    tt = recording(FederatedTrainer)(tm, train, test, parts, FLConfig(
        scheduler_backend=backend, device="cpu", **cfg_kw(scheduler)))
    tt.params = convert.params_from_jax(params0, tm.cfg, device="cpu")
    return tt, run(tt, 3)


def assert_records(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float):
            assert np.isclose(a[k], b[k], atol=ATOL, rtol=RTOL), (k, a, b)
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def assert_params(jp, tp, cfg):
    back = convert.params_to_jax(tp, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL)


def test_single_cell_rounds_match_reference(world, reference_run):
    """3 rounds of the scheduler: masks and iteration counts equal (2-3 of
    6 devices a round), sigmas, delta norms, records and params close;
    the port's torch backend bitwise equal to its numpy backend."""
    scheduler, params0, jt, jrecs = reference_run
    tt, trecs = port_run(world, scheduler, "numpy", params0)
    assert [int(m.sum()) for m, _, _ in jt.log] == [3, 2, 3]
    for (jm_, ji, jn), (tm_, ti, tn) in zip(jt.log, tt.log):
        np.testing.assert_array_equal(jm_, tm_)
        assert ji == ti
        np.testing.assert_allclose(tn, jn, atol=ATOL, rtol=RTOL)
    for js, ts in zip(jt.sigmas, tt.sigmas):
        np.testing.assert_allclose(ts, js, atol=ATOL, rtol=RTOL)
    for a, b in zip(jrecs, trecs):
        assert_records(a, b)
        assert tt.last_round_host_syncs == 2
    assert_params(jt.params, tt.params, tt.model.cfg)
    tb, brecs = port_run(world, scheduler, "torch", params0)
    assert brecs == trecs
    for (m1, i1, n1), (m2, i2, n2) in zip(tt.log, tb.log):
        assert np.array_equal(m1, m2) and i1 == i2
        assert np.array_equal(n1, n2)
    assert all(np.array_equal(a, b) for a, b in zip(tt.sigmas, tb.sigmas))
    assert all(torch.equal(tt.params[k], tb.params[k]) for k in tt.params)


def test_two_cells_match_reference(world):
    """``MultiCellTrainer`` with C = 2 against the reference engine (numpy
    backend), 2 FSCD rounds, from the reference's cell params: records
    equal within tolerance, params close; no dropout masks to pad."""
    jm, tm, train, test, parts = world
    jmc = JMultiCell(jm, train, test, parts, JFLConfig(
        scheduler_backend="numpy", **cfg_kw("fedcgd-fscd", cells=2)))
    mc = MultiCellTrainer(tm, train, test, parts, FLConfig(
        scheduler_backend="torch", device="cpu",
        **cfg_kw("fedcgd-fscd", cells=2)))
    mc._params_c = convert.cell_params_from_jax(
        jax.tree.map(np.asarray, jmc._params_c), tm.cfg, device="cpu")
    for c, cell in enumerate(mc.cells):
        cell.params = {k: x[c] for k, x in mc._params_c.items()}
        assert cell._draw_dropout(6) == ()
    assert _pad_batches((), 3) == ()
    for j in range(2):
        jr, tr = jmc.run_round(j), mc.run_round(j)
        assert len(jr) == len(tr) == 2
        for a, b in zip(jr, tr):
            assert_records(a, b)
        assert mc.last_round_host_syncs == 2
    for c in range(2):
        assert_params(jax.tree.map(lambda x: x[c], jmc._params_c),
                      {k: x[c] for k, x in mc._params_c.items()}, tm.cfg)


# ---------------------------------------------------------------------------
# Section IV: CGD and the virtual centralized model


def tree_pair(rng, like, scale=1.0):
    """The same random tree for both packages: numpy leaves shaped like
    the port's (flat) ``like`` -> (port tree, JAX tree)."""
    t = {k: (scale * rng.normal(size=tuple(x.shape))).astype(np.float32)
         for k, x in like.items()}
    return ({k: torch.from_numpy(v) for k, v in t.items()},
            {k: jnp.asarray(v) for k, v in t.items()})


@pytest.mark.parametrize("tree", ["vector", "resnet"])
def test_cgd_matches_reference(models, tree):
    """Eq. 5, the individual divergences and U_j against the reference on
    the same trees: a 6-vector and a ResNet18-GN parameter tree."""
    like = ({"w": torch.zeros(6)} if tree == "vector"
            else models[3])
    rng = np.random.default_rng(4)
    devs = [tree_pair(rng, like) for _ in range(3)]
    gF_t, gF_j = tree_pair(rng, like, 0.5)
    alphas = np.array([0.5, 0.3, 0.2])
    got = float(cgd.device_level_cgd([t for t, _ in devs], alphas, gF_t))
    want = float(jcgd.device_level_cgd([j for _, j in devs], alphas, gF_j))
    assert got == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(
        cgd.individual_divergences([t for t, _ in devs], gF_t),
        jcgd.individual_divergences([j for _, j in devs], gF_j), rtol=1e-5)
    assert float(cgd.fc_difference(devs[0][0], gF_t)) == pytest.approx(
        float(jcgd.fc_difference(devs[0][1], gF_j)), rel=1e-5)


def test_bounds_match_reference():
    for args in [(2.0, 4, 32), (0.7, 0, 32), (3.0, 17, 8)]:
        assert cgd.sample_level_bound(*args) == jcgd.sample_level_bound(
            *args)
    for args in [(3, 0.1, 1.0, 5.0), (1, 0.1, 1.0, 5.0), (5, 0.02, 2.0,
                                                          0.3)]:
        assert cgd.local_iter_bias_bound(*args) == \
            jcgd.local_iter_bias_bound(*args)
    kw = dict(delta=0.5, sigma=2.0, num_scheduled=4, batch_size=32, tau=3,
              eta=0.1, beta=1.0, g=5.0)
    assert cgd.theorem1_bound(**kw) == jcgd.theorem1_bound(**kw)


def vec(v):
    return {"w": torch.as_tensor(v, dtype=torch.float32)}


def test_collective_vs_individual_divergence():
    """Remark 1 / Fig. 2: two 'bad' complementary devices can have lower
    COLLECTIVE divergence than one 'good' device."""
    gF = vec(np.zeros(4))
    g1, g2, g3 = vec(np.full(4, 0.3)), vec(np.full(4, 2.0)), vec(
        np.full(4, -2.0))
    d = cgd.individual_divergences([g1, g2, g3], gF)
    assert d[0] < d[1] and d[0] < d[2]
    assert float(cgd.device_level_cgd([g2, g3], [0.5, 0.5], gF)) < d[0]


def test_full_participation_zero_cgd_and_triangle_inequality():
    rng = np.random.default_rng(0)
    gs = [vec(v) for v in rng.normal(size=(5, 6))]
    alphas = np.ones(5) / 5
    gF = {"w": torch.stack([g["w"] for g in gs]).mean(0)}
    assert float(cgd.device_level_cgd(gs, alphas, gF)) < 1e-6
    rng = np.random.default_rng(1)
    gs = [vec(v) for v in rng.normal(size=(4, 8))]
    gF = vec(rng.normal(size=8))
    alphas = np.ones(4) / 4
    coll = float(cgd.device_level_cgd(gs, alphas, gF))
    assert coll <= (alphas * cgd.individual_divergences(gs, gF)).sum() + 1e-6


def test_theorem1_bound_dominates_terms():
    b = cgd.theorem1_bound(delta=0.5, sigma=2.0, num_scheduled=4,
                           batch_size=32, tau=3, eta=0.1, beta=1.0, g=5.0)
    assert b >= cgd.local_iter_bias_bound(3, 0.1, 1.0, 5.0)
    assert b >= 0.1 * 3 * 0.5
    assert cgd.local_iter_bias_bound(1, 0.1, 1.0, 5.0) == 0.0


def test_virtual_step_matches_reference(models):
    """v = w - eta tau grad F on a pooled ResNet batch: the virtual model,
    its gradients and loss against the reference's, and U_j of the
    reference's and the port's v against each other's w."""
    jm, tm, jp, tp = models
    x = images(4, 16, seed=5)
    y = np.array([3, 3, 50, 97], np.int32)
    jv, jg, jl = jax.jit(j_virtual_step, static_argnums=(0, 3, 4))(
        jm.loss_fn, jp, {"images": jnp.asarray(x),
                         "labels": jnp.asarray(y)}, 0.1, 2)
    tv, tg, tl = virtual_step(tm.loss_fn, tp, {
        "images": torch.from_numpy(x), "labels": torch.from_numpy(y)},
        0.1, 2)
    close(tl, jl)
    assert_params(jv, tv, tm.cfg)
    assert_params(jg, tg, tm.cfg)
    u_t = float(cgd.fc_difference(tp, tv))
    u_j = float(jcgd.fc_difference(jp, jv))
    assert u_t == pytest.approx(u_j, rel=1e-4)
    assert u_t == pytest.approx(0.2 * float(torch.sqrt(sum(
        (g * g).sum() for g in tg.values()))), rel=1e-4)
