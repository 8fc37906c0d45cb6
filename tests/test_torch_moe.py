"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``, its path with every expert local), and a
train step of a dense and an MoE model against ``jax.value_and_grad`` of
the reference's ``loss_fn``, on reduced f32 configs from converted JAX
weights (zero-initialised leaves made nonzero, ``test_torch_zoo.nonzero``).

Routing decisions must match exactly: the experts each token picks (ties
at the lower index), each assignment's arrival rank within its expert,
and so the set of assignments dropped at an expert's capacity.
Tolerances: outputs at 1e-5 (``tests/test_torch_lm.py``'s layer
tolerance), the aux loss at 1e-5 relative; the train step's losses within
1e-5 relative and its new params and their updates (eta times the
gradients) within 1e-4 relative in L2 a leaf, as
``tests/test_torch_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_zoo import cfgs, weights

from repro.configs import get_config as j_get_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.fl import distributed as TD
from repro_torch.models import moe as TM

ATOL = RTOL = 1e-5
AUX_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4


def tiny_cfgs(**kw):
    """The reference test's config: qwen3-moe reduced (4 experts, top-2)."""
    base = "qwen3-moe-235b-a22b"
    return (dataclasses.replace(j_get_config(base).reduced(), **kw),
            dataclasses.replace(get_config(base).reduced(), **kw))


def moe_params(jcfg, seed=0):
    jp = JM.moe_params_init(jax.random.key(seed), jcfg, jnp.float32)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def close_aux(got, want):
    assert abs(float(got) - float(want)) <= AUX_RTOL * abs(float(want)), \
        (float(got), float(want))


def t_fits(tp, tcfg, x):
    """The port's kept assignments [T, k] for tokens x [B,S,d], from its
    own routing, ranks and capacity."""
    xt = t(x).reshape(-1, x.shape[-1])
    _, experts, _ = TM.top_k_routing(TM._router_logits(tp, xt),
                                     tcfg.experts_per_token)
    pos, _ = TM._positions_in_expert(experts.reshape(-1), tcfg.num_experts)
    cap = TM._capacity(xt.shape[0], tcfg.experts_per_token,
                       tcfg.num_experts, tcfg.capacity_factor)
    return (pos < cap).reshape(experts.shape)


def j_moe(jp, jcfg, x):
    """The reference's ``moe_ffn`` (no mesh), jitted: (y, aux)."""
    return jax.jit(lambda p, x: JM.moe_ffn(p, jcfg, x, ctx=None))(
        jp, jnp.asarray(x))


def j_fits(jp, jcfg, x):
    """The reference's kept assignments [T, k] (bool) for tokens x [B,S,d],
    from its own routing, ranks and capacity."""
    xt = x.reshape(-1, x.shape[-1])
    logits = jax.lax.dot_general(
        xt, jp["router"].astype(xt.dtype), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    _, experts, _ = JM.top_k_routing(logits, jcfg.experts_per_token)
    pos, _, _, _ = JM._positions_in_expert(experts.reshape(-1),
                                           jcfg.num_experts)
    cap = JM._capacity(xt.shape[0], jcfg.experts_per_token,
                       jcfg.num_experts, jcfg.capacity_factor)
    return np.asarray(pos < cap).reshape(experts.shape)


# ---------------------------------------------------------------------------
# the reference's tests/test_moe.py cases, against the reference


def test_moe_matches_reference_with_ample_capacity():
    jcfg, tcfg = tiny_cfgs(capacity_factor=8.0)     # no drops
    jp, tp = moe_params(jcfg)
    for p in (jp, tp):
        p.pop("shared", None)
        p.pop("dense_residual", None)
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 8, jcfg.d_model)))
    jy, jaux = j_moe(jp, jcfg, x)
    ty, taux = TM.moe_ffn(tp, tcfg, t(x))
    close(ty, jy)
    close_aux(taux, jaux)
    assert bool(t_fits(tp, tcfg, x).all()) and float(taux) >= 0


@pytest.mark.parametrize("factor,B,S,drops", [(0.1, 2, 16, False),
                                              (0.1, 2, 40, True),
                                              (0.5, 4, 64, True),
                                              (1.0, 4, 64, True)])
def test_capacity_drops_match_reference(factor, B, S, drops):
    """Past 32 tokens the capacity can bind: the port drops the
    reference's assignments (the last arrivals at each full expert), and
    its output and aux loss match; at 32 tokens or fewer (the floor of
    ``_capacity``) nothing drops."""
    jcfg, tcfg = tiny_cfgs(capacity_factor=factor)
    jp, tp = moe_params(jcfg)
    x = np.random.default_rng(B * S).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    jy, jaux = j_moe(jp, jcfg, x)
    ty, taux = TM.moe_ffn(tp, tcfg, t(x))
    want = j_fits(jp, jcfg, jnp.asarray(x))
    np.testing.assert_array_equal(t_fits(tp, tcfg, x).numpy(), want)
    assert bool((~want).any()) == drops, (B * S, int((~want).sum()))
    close(ty, jy)
    close_aux(taux, jaux)


def test_positions_in_expert():
    flat = np.asarray([2, 0, 2, 1, 2, 0])
    pos, sizes = TM._positions_in_expert(t(flat), 3)
    np.testing.assert_array_equal(sizes.numpy(), [2, 1, 3])
    np.testing.assert_array_equal(pos.numpy(), [0, 0, 1, 0, 2, 1])
    flat = np.random.default_rng(0).integers(0, 5, 300)
    jpos, jsizes, _, _ = JM._positions_in_expert(jnp.asarray(flat), 5)
    pos, sizes = TM._positions_in_expert(t(flat), 5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))


def test_top_k_routing_matches_reference_and_breaks_ties_low():
    logits = np.array(jax.random.normal(jax.random.key(0), (10, 8)))
    # exact ties: three equal maxima, and a row of equal logits
    logits[0, [1, 4, 6]] = 5.0
    logits[1] = 0.25
    jw, je, jprobs = JM.top_k_routing(jnp.asarray(logits), 3)
    w, e, probs = TM.top_k_routing(t(logits), 3)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(e[:2].numpy(), [[1, 4, 6], [0, 1, 2]])
    close(w, jw)
    close(probs, jprobs)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)
    assert (w >= 0).all() and int(e.max()) < 8


def test_aux_loss_balanced_lower_than_skewed():
    """Router logits that send every token to expert 0 give a larger aux
    loss than a zero router (uniform probabilities), in both packages."""
    jcfg, tcfg = tiny_cfgs()
    jp, tp = moe_params(jcfg)
    x = np.random.default_rng(1).normal(
        size=(1, 64, jcfg.d_model)).astype(np.float32)
    aux = {}
    for name, router in (("balanced", np.zeros_like(np.asarray(jp["router"]))),
                         ("skewed", np.zeros_like(np.asarray(jp["router"])))):
        if name == "skewed":
            router[:, 0] = np.sign(x[0].mean(0)) * 10.0
        jp["router"], tp["router"] = jnp.asarray(router), t(router)
        _, jaux = j_moe(jp, jcfg, x)
        _, aux[name] = TM.moe_ffn(tp, tcfg, t(x))
        close_aux(aux[name], jaux)
    assert float(aux["balanced"]) < float(aux["skewed"])


def test_shared_and_dense_residual_paths():
    jcfg, tcfg = tiny_cfgs(num_shared_experts=1, moe_dense_ff=32)
    jp, tp = moe_params(jcfg)
    assert "shared" in tp and "dense_residual" in tp
    x = np.asarray(jax.random.normal(jax.random.key(1), (1, 4, jcfg.d_model)))
    jy, jaux = j_moe(jp, jcfg, x)
    ty, taux = TM.moe_ffn(tp, tcfg, t(x))
    close(ty, jy)
    close_aux(taux, jaux)


def test_bf16_router_logits_stay_f32():
    """bf16 tokens and router: the logits are the f32 sums of the bf16
    products (never rounded to bf16), and the routing is the
    reference's."""
    jcfg, tcfg = tiny_cfgs(num_experts=4)
    jp, tp = moe_params(jcfg)
    x = np.random.default_rng(2).normal(
        size=(256, jcfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax.lax.dot_general(xb, jp["router"].astype(jnp.bfloat16),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)
    got = TM._router_logits(tp, t(np.asarray(xb, np.float32)).to(
        torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    _, je, _ = JM.top_k_routing(want, 2)
    _, e, _ = TM.top_k_routing(got, 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    rounded = got.to(torch.bfloat16)
    assert not torch.equal(rounded.float(), got)


# ---------------------------------------------------------------------------
# one train step of a dense and an MoE model against jax.value_and_grad


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("arch", ["qwen2-7b", "moonshot-v1-16b-a3b",
                                  "gemma3-27b", "llama-3.2-vision-11b",
                                  "musicgen-large", "arctic-480b"])
def test_train_step_matches_value_and_grad(arch):
    """``make_train_step`` (eta 0.1) on 4 sequences of 12 tokens: loss,
    CE and aux against the reference's ``loss_fn`` under
    ``jax.value_and_grad``, and every new param and its update (-eta x
    the gradient) against the reference's gradient step; the MoE's 48
    tokens run at its published capacity factor (1.25, so the capacity
    floor of 32 binds).  gemma3-27b: QK norm and the tied head;
    llama-3.2-vision-11b: the cross layers and their gates over 16
    encoder embeddings; musicgen-large: frame embeddings in place of the
    tokens; arctic-480b: the dense residual beside the experts."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = weights(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (4, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if jcfg.family == "audio":
        batch["frame_embeddings"] = rng.normal(
            size=(4, 12, jcfg.encoder_dim)).astype(np.float32)
        del batch["tokens"]
    if jcfg.family == "vlm":
        batch["encoder_embeddings"] = rng.normal(
            size=(4, jcfg.num_encoder_tokens, jcfg.encoder_dim)).astype(
                np.float32)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tmet = TD.make_train_step(tcfg, eta=0.1)(
        tp, {k: t(v).long() if v.dtype == np.int32 else t(v)
             for k, v in batch.items()})
    for got, want in ((tmet["loss"], jloss), (tmet["ce_loss"],
                                              jmet["ce_loss"])):
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    if tcfg.num_experts:
        close_aux(tmet["aux_loss"], jmet["aux_loss"])
    old = flat(jax.tree.map(np.asarray, jp))
    grads = flat(jax.tree.map(np.asarray, jgrads))
    got = flat(convert.lm_params_to_jax(tnew))
    assert got.keys() == grads.keys()
    for k, g in grads.items():
        want = old[k] - 0.1 * g
        assert rel_l2(got[k], want) <= PARAM_RTOL, k
        if np.any(g != 0):
            assert rel_l2(got[k] - old[k], want - old[k]) <= PARAM_RTOL, \
                (k, rel_l2(got[k] - old[k], want - old[k]))
