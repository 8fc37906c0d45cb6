"""The port's LM training path against the JAX package, on the reduced f32
configs of recurrentgemma-2b (3 layers; its embedding is tied, so the
head's gradient and the gather's meet in one leaf) and rwkv6-3b, from
converted JAX weights: ``softmax_cross_entropy_sums``, ``_chunked_ce``,
``loss_fn`` on both of its branches, ``fl.distributed``'s train step
(plain and schedule-weighted), prefill and serve steps, the optimizers,
the checkpoints and the two training entry points.

Tolerances (f32; both packages compute one f32 function in other
summation orders): losses within 1e-5 relative; new params, their
updates and the gradient norm within 1e-4 relative in L2 per leaf;
prefill logits within 1e-4 x max(1, max |logit|) and caches at 1e-5, as
``tests/test_torch_lm.py``; optimizers within 1e-6; checkpoints bit for
bit."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load
from repro.checkpoint import save_pytree as j_save
from repro.configs import get_config as j_get_config
from repro.core import Problem as JProblem
from repro.core import fscd as j_fscd
from repro.fl import distributed as JD
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro_torch import convert
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.fl import distributed as TD
from repro_torch.kernels import common
from repro_torch.launch import federated_lm_silos, train
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build_model
from repro_torch.optim import optimizers as TO

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
OPT_TOL = 1e-6
ARCHS = ("recurrentgemma-2b", "rwkv6-3b")


def cfgs(arch, **kw):
    return j_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@functools.lru_cache(maxsize=None)
def weights(arch, seed=0, **kw):
    jcfg, _ = cfgs(arch, **kw)
    jp = JT.init(jax.random.key(seed), jcfg)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def lm_batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch, device="cpu"):
    return {k: t(v).to(device) for k, v in batch.items()}


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def close_loss(got, want):
    want = float(want)
    assert abs(float(got) - want) <= LOSS_RTOL * abs(want), (got, want)


def close_params(got, want, before=None, rtol=PARAM_RTOL):
    """Every leaf of the port's params (torch) against the JAX package's
    (numpy) in relative L2; with ``before``, the updates too."""
    got = dict(leaves(convert.lm_params_to_jax(got)))
    want = dict(leaves(jax.tree.map(np.asarray, want)))
    assert got.keys() == want.keys()
    old = dict(leaves(jax.tree.map(np.asarray, before))) if before else {}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel_l2(got[k], want[k]) <= rtol, (k, rel_l2(got[k], want[k]))
        if k in old and np.any(want[k] != old[k]):
            du = rel_l2(got[k] - old[k], want[k] - old[k])
            assert du <= rtol, (k, "update", du)


# ---------------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_sums(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32) * 1.5
    for m in (None, mask):
        got = TL.softmax_cross_entropy_sums(
            t(logits), t(targets), None if m is None else t(m), smoothing)
        want = JL.softmax_cross_entropy_sums(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m), smoothing)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,chunk", [(12, 5), (12, 4), (7, 512)])
def test_chunked_ce_matches_reference(arch, S, chunk):
    """The chunk loop at a small chunk (the tail padded with zero weight)
    and at a chunk longer than S, with and without a loss mask, on the
    reference trunk's hidden states, against the reference's
    ``_chunked_ce``."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = weights(arch)
    batch = lm_batch(jcfg, 2, S, seed=S + chunk)
    x, _ = JT.forward_hidden(jp, jcfg, as_jax(batch))
    mask = (np.random.default_rng(1).random((2, S)) < 0.8).astype(np.float32)
    for m in (None, mask):
        want = JT._chunked_ce(jp, jcfg, x, jnp.asarray(batch["targets"]),
                              None if m is None else jnp.asarray(m), None,
                              0.0, chunk=chunk)
        got = TT._chunked_ce(tp, tcfg, t(np.asarray(x)), t(batch["targets"]),
                             None if m is None else t(m), 0.0, chunk=chunk)
        close_loss(got, want)


@pytest.mark.parametrize("arch,S,vocab", [("recurrentgemma-2b", 12, None),
                                          ("rwkv6-3b", 12, None),
                                          ("recurrentgemma-2b", 520, 32768)])
def test_loss_fn_matches_reference_on_both_branches(arch, S, vocab):
    """S * vocab <= 2**24 takes the full head and CE; 520 x 32768 > 2**24
    takes the chunked CE (chunks of 512, the tail of 8 padded); the
    registry's ``loss_fn`` is the model's."""
    kw = {} if vocab is None else {"vocab_size": vocab}
    jcfg, tcfg = cfgs(arch, **kw)
    assert (S * tcfg.vocab_size > 1 << 24) == (vocab is not None)
    jp, tp = weights(arch, **kw)
    batch = lm_batch(jcfg, 2, S, seed=3)
    batch["loss_mask"] = (np.random.default_rng(2).random((2, S))
                          < 0.9).astype(np.float32)
    jt, jm = JT.loss_fn(jp, jcfg, as_jax(batch))
    tt, tm = build_model(tcfg).loss_fn(tp, as_torch(batch))
    close_loss(tt, jt)
    assert set(tm) == set(jm) == {"ce_loss", "aux_loss"}
    close_loss(tm["ce_loss"], jm["ce_loss"])
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0


# ---------------------------------------------------------------------------
# the train step


def j_step(jcfg, jp, batch, eta, federated):
    return JD.make_train_step(jcfg, None, eta=eta, federated=federated)(
        jp, as_jax(batch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("federated", [False, True])
def test_train_step_matches_reference(arch, federated):
    """One step: loss, ce_loss, grad_norm and every new param (and its
    update) against the reference's ``make_train_step``; the federated
    step weighs 4 silos of 2 examples by ``silo_weights`` of a 3-of-4
    schedule; the params passed in are left as they were."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = weights(arch)
    batch = lm_batch(jcfg, 8, 10, seed=5)
    if federated:
        w = np.repeat(np.asarray(JD.silo_weights(np.array([1, 0, 1, 1]), 4)),
                      2)
        np.testing.assert_array_equal(
            TD.silo_weights(np.array([1, 0, 1, 1]), 4).numpy(),
            np.asarray(JD.silo_weights(np.array([1, 0, 1, 1]), 4)))
        batch["schedule_weights"] = w.astype(np.float32)
    before = {k: v.clone() for k, v in leaves(tp)}
    jnew, jmet = j_step(jcfg, jp, batch, 0.1, federated)
    tnew, tmet = TD.make_train_step(tcfg, eta=0.1, federated=federated)(
        tp, as_torch(batch))
    for k in ("loss", "ce_loss"):
        close_loss(tmet[k], jmet[k])
    assert rel_l2(float(tmet["grad_norm"]), float(jmet["grad_norm"])) \
        <= PARAM_RTOL
    close_params(tnew, jnew, before=jp)
    assert all(torch.equal(v, before[k]) for k, v in leaves(tp))


@pytest.mark.parametrize("remat", [False, True])
def test_rwkv_federated_step_across_chunks_matches_reference(remat):
    """rwkv6-3b's schedule-weighted step over 37 tokens (the reference's
    chunked WKV pads them to three chunks of 16), with and without
    per-layer remat, against the reference's step."""
    jcfg, tcfg = cfgs("rwkv6-3b", remat=remat)
    jp, tp = weights("rwkv6-3b")
    batch = lm_batch(jcfg, 4, 37, seed=12)
    batch["schedule_weights"] = np.asarray(
        JD.silo_weights(np.array([0, 1, 1, 1]), 4)).astype(np.float32)
    jnew, jmet = j_step(jcfg, jp, batch, 0.1, True)
    tnew, tmet = TD.make_train_step(tcfg, eta=0.1, federated=True)(
        tp, as_torch(batch))
    close_loss(tmet["loss"], jmet["loss"])
    assert rel_l2(float(tmet["grad_norm"]), float(jmet["grad_norm"])) \
        <= PARAM_RTOL
    close_params(tnew, jnew, before=jp)


def test_train_step_remat_and_bf16_params():
    """``remat=True`` (each layer under torch.utils.checkpoint) gives the
    step without it; bf16 params step in bf16 (p - eta * g in the leaf's
    dtype, as the reference)."""
    _, tcfg = cfgs("recurrentgemma-2b")
    _, tp = weights("recurrentgemma-2b")
    batch = as_torch(lm_batch(tcfg, 4, 10, seed=6))
    plain = TD.make_train_step(tcfg)(tp, batch)
    remat = TD.make_train_step(dataclasses.replace(tcfg, remat=True))(
        tp, batch)
    close_loss(remat[1]["loss"], plain[1]["loss"])
    for (k, a), (_, b) in zip(leaves(remat[0]), leaves(plain[0])):
        assert rel_l2(a.numpy(), b.numpy()) <= 1e-6, k
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16",
                               param_dtype="bfloat16")
    jp, _ = weights("recurrentgemma-2b")
    bp = convert.lm_params_from_jax(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp), "cpu")
    new, met = TD.make_train_step(bcfg)(bp, batch)
    assert all(v.dtype == torch.bfloat16 for _, v in leaves(new))
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_schedule_weight_identities(arch):
    """An all-ones schedule reproduces the plain step; a 2-of-4 schedule
    equals the plain step on the scheduled silos' examples alone."""
    _, tcfg = cfgs(arch)
    _, tp = weights(arch)
    batch = lm_batch(tcfg, 8, 9, seed=7)
    plain = TD.make_train_step(tcfg, eta=0.1)
    fed = TD.make_train_step(tcfg, eta=0.1, federated=True)

    def check(a, b):
        close_loss(a[1]["loss"], b[1]["loss"])
        assert rel_l2(float(a[1]["grad_norm"]), float(b[1]["grad_norm"])) \
            <= PARAM_RTOL
        for (k, x), (_, y) in zip(leaves(a[0]), leaves(b[0])):
            assert rel_l2(x.numpy(), y.numpy()) <= PARAM_RTOL, k

    ones = TD.silo_weights(np.ones(4), 4).repeat_interleave(2)
    check(fed(tp, {**as_torch(batch), "schedule_weights": ones}),
          plain(tp, as_torch(batch)))
    mask = np.array([0, 1, 0, 1])
    w = TD.silo_weights(mask, 4).repeat_interleave(2)
    keep = np.repeat(mask.astype(bool), 2)
    check(fed(tp, {**as_torch(batch), "schedule_weights": w}),
          plain(tp, as_torch({k: v[keep] for k, v in batch.items()})))


# ---------------------------------------------------------------------------
# the serving steps


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_reference(arch):
    """``make_prefill_step`` (the head on the last position only) and
    ``make_serve_step`` against the reference's: logits [B,1,V] within
    1e-4 x max(1, max |logit|), every cache leaf at 1e-5 (integer fields
    equal; the WKV state at rtol 1e-4, tests/test_torch_lm.py says why),
    and the prefill logits equal to the full forward's last position."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = weights(arch)
    toks = lm_batch(jcfg, 2, 20, seed=8)["tokens"]
    jl, jc = JD.make_prefill_step(jcfg, None, 32)(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TD.make_prefill_step(tcfg, 32)(tp, {"tokens": t(toks)})
    assert tuple(tl.shape) == (2, 1, tcfg.vocab_size)

    def close_logits(got, want):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), err

    def close_cache(got, want, path=""):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                close_cache(got[k], want[k], f"{path}/{k}")
            return
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
        else:
            rtol = 1e-4 if path.endswith("wkv") else 1e-5
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                       rtol=rtol, err_msg=path)

    close_logits(tl, jl)
    close_cache(tc, jc)
    full, _, _ = TT.forward(tp, tcfg, {"tokens": t(toks)})
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1].numpy(),
                               atol=1e-5, rtol=1e-5)
    nxt = toks[:, -1:]
    jl2, jc2 = JD.make_serve_step(jcfg, None)(jp, jc,
                                              {"tokens": jnp.asarray(nxt)})
    tl2, tc2 = TD.make_serve_step(tcfg)(tp, tc, {"tokens": t(nxt)})
    close_logits(tl2, jl2)
    close_cache(tc2, jc2)


# ---------------------------------------------------------------------------
# optimizers and checkpoints


def opt_tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                  "d": rng.normal(size=(2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "weight_decay": 0.01}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.01, "b2": 0.99})])
def test_optimizers_match_reference(name, kw):
    """Four steps of updates, states and applied params within 1e-6."""
    rng = np.random.default_rng(9)
    params = opt_tree(rng)
    jopt = JO.make_optimizer(name, 0.01, **kw)
    topt = TO.make_optimizer(name, 0.01, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(t, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = opt_tree(rng)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(jax.tree.map(t, g), ts, tp)
        jp = JO.apply_updates(jp, ju)
        tp = TO.apply_updates(tp, tu)
        for got, want in zip(jax.tree.leaves((tu, ts, tp)),
                             jax.tree.leaves((ju, js, jp))):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=OPT_TOL, atol=OPT_TOL)
    if name == "adamw":
        state = topt.init({"w": torch.zeros(3, dtype=torch.bfloat16)})
        assert state["m"]["w"].dtype == torch.float32
        assert state["t"].dtype == torch.int32


def test_checkpoints_cross_load(tmp_path):
    """f32 leaves cross-load both ways bit for bit; the reference's bf16
    leaves load into the port bit for bit; the port writes each array with
    the reference's dtype descr and bytes (bf16 as |V2 bit patterns), and
    reads its own file back bit for bit; metadata goes to .meta.json."""
    jp, tp = weights("recurrentgemma-2b")
    j_save(str(tmp_path / "ref"), jp, {"by": "reference"})
    got = load_pytree(str(tmp_path / "ref"), tp)
    for (k, a), (_, b) in zip(leaves(got), leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    save_pytree(str(tmp_path / "port"), tp, {"by": "port"})
    assert json.loads((tmp_path / "port.meta.json").read_text()) \
        == {"by": "port"}
    back = j_load(str(tmp_path / "port"), jp)
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back),
                 jax.tree.map(np.asarray, jp))

    jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    tb = convert.lm_params_from_jax(jax.tree.map(np.asarray, jb), "cpu")
    j_save(str(tmp_path / "ref_bf16"), jb)
    got = load_pytree(str(tmp_path / "ref_bf16.npz"), tb)
    for (k, a), (_, b) in zip(leaves(got), leaves(tb)):
        assert a.dtype == torch.bfloat16 and torch.equal(
            a.view(torch.int16), b.view(torch.int16)), k
    save_pytree(str(tmp_path / "port_bf16"), tb)
    ref_file = np.load(tmp_path / "ref_bf16.npz")
    port_file = np.load(tmp_path / "port_bf16.npz")
    assert sorted(ref_file.files) == sorted(port_file.files)
    for k in ref_file.files:
        a, b = ref_file[k], port_file[k]
        assert a.dtype.str == b.dtype.str and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert ref_file["embed"].dtype.str == "|V2"
    mine = load_pytree(str(tmp_path / "port_bf16"), tb)
    for (k, a), (_, b) in zip(leaves(mine), leaves(tb)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k


# ---------------------------------------------------------------------------
# the training entry points


def test_silo_training_matches_reference_pieces():
    """Two FedCGD rounds of ``launch.federated_lm_silos.run`` (4 silos of
    2 sequences of 16 tokens) against the JAX example's loop built from
    the reference's pieces on the same data and weights: the masks equal,
    the losses and final params within tolerance."""
    jcfg, tcfg = cfgs("recurrentgemma-2b")
    jp, tp = weights("recurrentgemma-2b")
    silos, b, seq, C = 4, 2, 16, 8
    params, hist = federated_lm_silos.run(
        tcfg, rounds=2, silos=silos, per_silo_batch=b, seq=seq,
        superclasses=C, device="cpu", params=tp)
    ds, silo_idx, histogram = federated_lm_silos.silo_world(tcfg, silos, seq,
                                                            C)
    rng = np.random.default_rng(0)
    step = JD.make_train_step(jcfg, None, eta=0.05, federated=True)
    for rec in hist:
        takes = [rng.choice(silo_idx[s], size=b) for s in range(silos)]
        sched = j_fscd(JProblem(
            p_dev=np.stack([histogram(ds.inputs[x]) for x in takes]),
            global_dist=histogram(ds.inputs), class_weights=np.ones(C),
            sigma=1.0, batch_size=b * seq, min_bw=np.ones(silos),
            total_bw=float(silos)))
        np.testing.assert_array_equal(rec["mask"], sched.mask)
        toks = jnp.asarray(ds.inputs[np.concatenate(takes)])
        w = jnp.repeat(JD.silo_weights(sched.mask, silos), b)
        jp, jm = step(jp, {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                           "schedule_weights": w})
        close_loss(rec["metrics"]["loss"], jm["loss"])
    close_params(params, jp)


def test_train_entry_point_runs_on_cpu(tmp_path):
    """``launch.train.main`` on the CPU: finite losses, and ``--save``
    writes params that load back bit for bit."""
    lines = []
    cfg = get_config("rwkv6-3b").reduced()
    params, metrics = train.train(cfg, steps=2, batch=2, seq=8, lr=0.05,
                                  device="cpu", log=lines.append)
    assert len(lines) == 3 and np.isfinite(float(metrics["loss"]))
    train.main(["--device", "cpu", "--reduced", "--arch", "rwkv6-3b",
                "--steps", "1", "--batch", "2", "--seq", "8",
                "--save", str(tmp_path / "p")])
    back = load_pytree(str(tmp_path / "p"), params)
    assert all(a.shape == b.shape for (_, a), (_, b)
               in zip(leaves(back), leaves(params)))


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_train_step_on_card_matches_cpu(cuda):
    """The reduced f32 recurrentgemma-2b step on the card (attention and
    RG-LRU through their kernels and backward kernels) against the same
    step on the CPU (the plain versions): loss within 1e-5 relative, new
    params within 1e-4 relative in L2 per leaf."""
    _, tcfg = cfgs("recurrentgemma-2b")
    _, tp = weights("recurrentgemma-2b")
    batch = lm_batch(tcfg, 4, 40, seed=10)
    step = TD.make_train_step(tcfg, eta=0.1)
    want, wmet = step(tp, as_torch(batch))
    common.reset_launches()
    got, gmet = step(jax.tree.map(lambda x: x.to(cuda), tp),
                     as_torch(batch, cuda))
    torch.cuda.synchronize()
    assert common.LAUNCHES["attention_bwd"] == 1
    assert common.LAUNCHES["rglru_bwd"] == 2
    close_loss(gmet["loss"].cpu(), wmet["loss"])
    for (k, a), (_, b) in zip(leaves(got), leaves(want)):
        assert rel_l2(a.cpu().numpy(), b.numpy()) <= PARAM_RTOL, k


@pytest.mark.requires_cuda
def test_rwkv_train_step_on_card_matches_cpu(cuda):
    """The reduced f32 rwkv6-3b federated step on the card (the WKV kernel
    saving its chunk states, then its backward kernel, once a layer)
    against the same step on the CPU (the plain version under autograd):
    loss within 1e-5 relative, new params within 1e-4 relative in L2 per
    leaf."""
    _, tcfg = cfgs("rwkv6-3b")
    _, tp = weights("rwkv6-3b")
    batch = lm_batch(tcfg, 4, 37, seed=11)
    batch["schedule_weights"] = np.repeat(np.asarray(
        TD.silo_weights(np.array([1, 0, 1, 1]), 4)), 1).astype(np.float32)
    step = TD.make_train_step(tcfg, eta=0.1, federated=True)
    want, wmet = step(tp, as_torch(batch))
    common.reset_launches()
    got, gmet = step(jax.tree.map(lambda x: x.to(cuda), tp),
                     as_torch(batch, cuda))
    torch.cuda.synchronize()
    assert dict(common.LAUNCHES) == {"wkv": tcfg.num_layers,
                                     "wkv_bwd": tcfg.num_layers}
    close_loss(gmet["loss"].cpu(), wmet["loss"])
    for (k, a), (_, b) in zip(leaves(got), leaves(want)):
        assert rel_l2(a.cpu().numpy(), b.numpy()) <= PARAM_RTOL, k
