"""The LM zoo's training path on the CPU: the MoE layer's fixed-order
backward (``repro_torch.models.moe``: ``_Dispatch`` and ``_Combine``)
against ``jax.grad`` of the JAX package's ``moe_ffn`` and against
autograd of the gather formulation it replaced; ``make_train_step``
(the new leaf formed in the gradient's buffer, the periods' gradients
added into one stack) bitwise equal to ``x - eta * g``; and
``repro_torch.roofline`` against ``repro.roofline``.

Tolerances: the MoE gradients within 1e-4 relative in L2 a leaf of the
reference's (``tests/test_torch_moe.py``'s train-step bound, f32); the
forward bitwise equal to the gather formulation's, its gradients within
1e-6 relative in L2 (the same f32 terms, the dispatch's k per token
summed in another order); the train step and the roofline's arithmetic
exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import j_fits, moe_params, t_fits

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.launch.shapes import SHAPES as J_SHAPES
from repro.models import moe as JM
from repro.roofline import analysis as JR
from repro_torch import roofline as TR
from repro_torch.configs import get_config, list_archs
from repro_torch.core.estimation import tree_leaves, tree_map
from repro_torch.fl import distributed as TD
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

GRAD_RTOL = 1e-4
ORDER_RTOL = 1e-6

# (capacity factor, experts, top-k, shared experts, dense residual, B, S):
# drops at factor 0.5 (past the 32-token floor; empty slots too); k = 3
# of 6 experts with drops, where the dispatch's backward adds three terms
# a token, and the shared expert and the dense residual beside the
# experts
MOE_CASES = [(0.5, 4, 2, 0, 0, 4, 64), (0.5, 6, 3, 1, 32, 4, 48)]
# the assignments each case drops (the reference's, as the test holds)
MOE_DROPS = [256, 288]


def rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def moe_case(factor, E, k, shared, dense, B, S):
    """(reference config, port config, reference params, port params, x,
    dy) on the reference test's reduced qwen3-moe, from seeded numpy."""
    base = "qwen3-moe-235b-a22b"
    kw = dict(capacity_factor=factor, num_experts=E, experts_per_token=k,
              num_shared_experts=shared, moe_dense_ff=dense)
    jcfg = dataclasses.replace(j_get_config(base).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(base).reduced(), **kw)
    jp, tp = moe_params(jcfg, seed=E + k)
    rng = np.random.default_rng(B * S + k)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x, dy


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def t_grads(fn, tp, x, dy):
    """Gradients of <y, dy> + aux over x and every param of ``fn``
    (``moe_ffn``'s signature) -> (y, {"x": .., "router": .., ...})."""
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in flat(tp).items()}
    tree = {}
    for k, v in leaves.items():
        *path, name = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = v
    xs = torch.from_numpy(x).requires_grad_(True)
    with torch.enable_grad():
        y, aux = fn(tree, xs)
        total = (y * torch.from_numpy(dy)).sum() + aux
        grads = torch.autograd.grad(total, [xs, *leaves.values()])
    return y.detach(), dict(zip(["x", *leaves], grads))


@pytest.mark.parametrize("factor,E,k,shared,dense,B,S,drops",
                         [c + (n,) for c, n in zip(MOE_CASES, MOE_DROPS)])
def test_moe_backward_matches_reference_grad(factor, E, k, shared, dense, B,
                                             S, drops):
    """Every gradient of the MoE layer (x, the router, the three expert
    tables, the shared and dense residual SwiGLUs) against ``jax.grad`` of
    the reference's ``moe_ffn``, and the assignments it drops equal."""
    jcfg, tcfg, jp, tp, x, dy = moe_case(factor, E, k, shared, dense, B, S)

    def j_total(p, x):
        y, aux = JM.moe_ffn(p, jcfg, x, ctx=None)
        return jnp.sum(y * dy) + aux
    jgx, jgp = jax.jit(jax.grad(j_total, argnums=(1, 0)))(jp, jnp.asarray(x))
    want = {"x": np.asarray(jgx), **{k: np.asarray(v) for k, v in
                                     flat(jgp).items()}}
    _, got = t_grads(lambda p, x: TM.moe_ffn(p, tcfg, x), tp, x, dy)
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert rel_l2(g.numpy(), want[name]) <= GRAD_RTOL, name
    fits = t_fits(tp, tcfg, x).numpy()
    np.testing.assert_array_equal(fits, j_fits(jp, jcfg, jnp.asarray(x)))
    assert int((~fits).sum()) == drops


def gather_moe_local(params, cfg, x, capacity):
    """The gather formulation the port ran before its dispatch and combine
    became fixed-order Functions: ``x_pad[src]`` and ``y_flat[idx]``
    differentiated by autograd (an accumulating scatter)."""
    T, d = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    weights, experts, probs = TM.top_k_routing(TM._router_logits(params, x),
                                               k)
    flat_e = experts.reshape(-1)
    pos, _ = TM._positions_in_expert(flat_e, E)
    fits = pos < capacity
    n_slots = E * capacity
    slot_flat = torch.where(fits, flat_e * capacity + pos, n_slots)
    token_idx = torch.arange(T * k) // k
    src = torch.full((n_slots + 1,), T, dtype=torch.long)
    src[slot_flat] = token_idx
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    x_buf = x_pad[src[:n_slots]].reshape(E, capacity, d)
    y_flat = TM._expert_ffn(params, x_buf).reshape(n_slots, d)
    slot_2d = slot_flat.reshape(T, k)
    w_2d = (weights.reshape(-1) * fits.to(torch.float32)).reshape(
        T, k).to(x.dtype)
    y = x.new_zeros((T, d))
    for j in range(k):
        idx = torch.clamp(slot_2d[:, j], 0, n_slots - 1)
        y = y + y_flat[idx] * w_2d[:, j, None]
    me = probs.mean(dim=0)
    ce = torch.bincount(flat_e, minlength=E).to(torch.float32) / (T * k)
    return y, me, ce


def gather_moe_ffn(params, cfg, x):
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = TM._capacity(B * S, k, E, cfg.capacity_factor)
    y, me, ce = gather_moe_local(params, cfg, x.reshape(B * S, d), cap)
    y = y.reshape(B, S, d)
    if "shared" in params:
        y = y + TM.swiglu(params["shared"], x)
    if "dense_residual" in params:
        y = y + TM.swiglu(params["dense_residual"], x)
    return y, cfg.router_aux_loss * E * torch.sum(me * ce)


@pytest.mark.parametrize("factor,E,k,shared,dense,B,S", MOE_CASES)
def test_moe_backward_matches_gather_formulation(factor, E, k, shared,
                                                 dense, B, S):
    """The fixed-order dispatch and combine against autograd of the gather
    formulation: the forward bitwise equal (f32 and bf16), the f32
    gradients within ``ORDER_RTOL``."""
    _, tcfg, _, tp, x, dy = moe_case(factor, E, k, shared, dense, B, S)
    y, got = t_grads(lambda p, x: TM.moe_ffn(p, tcfg, x), tp, x, dy)
    y0, want = t_grads(lambda p, x: gather_moe_ffn(p, tcfg, x), tp, x, dy)
    assert torch.equal(y, y0)
    for name, g in got.items():
        assert rel_l2(g.numpy(), want[name].numpy()) <= ORDER_RTOL, name
    bf = {k: v if k == "router" else tree_map(
        lambda a: a.to(torch.bfloat16), v) for k, v in tp.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(TM.moe_ffn(bf, tcfg, xb)[0],
                       gather_moe_ffn(bf, tcfg, xb)[0])


def test_dispatch_backward_sums_a_tokens_slots_in_order():
    """``_Dispatch``'s backward: token t's gradient is the f32 sum over j of
    its slots' rows, in order; a dropped slot (the scratch) and an empty
    slot add nothing; bf16 rows are summed in f32 and rounded once."""
    g = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    x = torch.zeros(3, 2, requires_grad=True)
    src = torch.tensor([0, 2, 3, 0])                # slot 2: token 3 = empty
    slot_2d = torch.tensor([[0, 3], [4, 4], [1, 4]])  # 4: dropped
    with torch.enable_grad():
        out = TM._Dispatch.apply(x, src, slot_2d)
        dx, = torch.autograd.grad(out, x, g)
    assert torch.equal(dx, torch.tensor([[8.0, 10.0], [0.0, 0.0],
                                         [3.0, 4.0]]))
    gb = torch.tensor([[1.0], [2.0 ** -8]], dtype=torch.bfloat16)
    xb = torch.zeros(1, 1, dtype=torch.bfloat16, requires_grad=True)
    with torch.enable_grad():
        out = TM._Dispatch.apply(xb, torch.tensor([0, 0]),
                                 torch.tensor([[0, 1, 1]]))
        dxb, = torch.autograd.grad(out, xb, gb)
    # 1 + 2^-8 + 2^-8 in f32 is 1 + 2^-7, a bf16 number; two bf16 sums
    # would round 1 + 2^-8 to 1 twice
    assert float(dxb) == 1.0 + 2.0 ** -7


def old_train_step(cfg, eta):
    """``make_train_step`` as it was: autograd.grad over every leaf, the
    new params ``x - eta * g`` beside the gradients, the grad norm over
    an f32 copy of each gradient squared out of place."""
    def train_step(params, batch):
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        with torch.enable_grad():
            total, metrics = TT.loss_fn(p, cfg, batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        with torch.no_grad():
            grads = iter([torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, grads)])
            grads = tree_map(lambda _: next(grads), p)
            new = tree_map(lambda x, g: x - eta * g.to(x.dtype), p, grads)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(x.to(
                torch.float32))) for x in tree_leaves(grads)))
        return new, dict(metrics, loss=total.detach(), grad_norm=gnorm)
    return train_step


@pytest.mark.parametrize("arch,dtype", [("qwen2-7b", "float32"),
                                        ("moonshot-v1-16b-a3b", "bfloat16")])
def test_train_step_bitwise_equal_to_old_formula(arch, dtype):
    """New params, loss and grad norm of a reduced dense (f32) and a
    reduced MoE (bf16, the card's dtype) config, each a stack of 2
    periods, bitwise equal to the old step's, each new leaf laid out as
    its param, the params passed in untouched."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                              param_dtype=dtype)
    params = TT.init(torch.Generator().manual_seed(3), cfg)
    before = tree_map(torch.clone, params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 17)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    new, met = TD.make_train_step(cfg, eta=0.1)(params, batch)
    old, omet = old_train_step(cfg, 0.1)(params, batch)
    for a, b, x, x0 in zip(tree_leaves(new), tree_leaves(old),
                           tree_leaves(params), tree_leaves(before)):
        assert torch.equal(a, b) and a.dtype == b.dtype
        assert a.stride() == x.stride() and torch.equal(x, x0)
    assert met.keys() == omet.keys()
    assert all(torch.equal(met[k], omet[k]) for k in met)


@pytest.mark.parametrize("arch", sorted(j_list_archs()))
def test_roofline_counts_match_reference(arch):
    """``count_params`` and ``model_flops`` (train, prefill, decode) equal
    the reference's for every config, and ``roofline_terms`` is the
    reference's arithmetic at the H100's peaks."""
    assert sorted(list_archs()) == sorted(j_list_archs())
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert TR.count_params(cfg) == JR.count_params(jcfg)
    for name, js in J_SHAPES.items():
        shape = TR.InputShape(js.name, js.seq_len, js.global_batch, js.kind)
        for kind in ("train", "prefill", "decode"):
            assert TR.model_flops(cfg, shape, kind) == JR.model_flops(
                jcfg, js, kind)


def test_roofline_terms_at_h100_peaks(monkeypatch):
    """The H100 SXM data sheet's peaks, and ``roofline_terms`` equal to the
    reference's with the reference's constants set to them."""
    assert (TR.PEAK_FLOPS, TR.TF32_FLOPS, TR.F32_FLOPS, TR.HBM_BW,
            TR.LINK_BW) == (989e12, 495e12, 67e12, 3.35e12, 900e9)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JR, name, getattr(TR, name))
    for args in ((4e15, 1e12, 0.0, 1, 3e15), (1e12, 5e12, 2e11, 4, 0.0),
                 (1e9, 1e6, 1e12, 2, 5e8)):
        got, want = TR.roofline_terms(*args), JR.roofline_terms(*args)
        assert got.to_dict() == want.to_dict()
