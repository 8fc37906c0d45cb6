"""moonlight-16b-a3b on the port: the configuration against the published
config, latent attention, the sigmoid router, the drop-free MoE over held
experts, the share of 8 chips adding up to the whole layer, and the
federated train step, each against the plain f32 reference
``tests/_moonlight_ref.py`` on the CPU (reduced widths, f32).  The
reference is held to the benchmark's own copy
(``portbench/reference/moonlight.py``) on one tiny case.  No JAX: the
JAX package has no such model."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

import _moonlight_ref as R
from repro_torch.configs import get_config, list_archs, port_archs
from repro_torch.configs.base import MLA, MLA_DENSE
from repro_torch.fl.distributed import make_train_step
from repro_torch.kernels import ops
from repro_torch.models import mla as A
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.obs import LayerTrace, Obs

ROOT = Path(__file__).resolve().parents[1]

# hf:moonshotai/Moonlight-16B-A3B config.json, the numbers that shape it
PUBLISHED = {
    "num_hidden_layers": 27, "hidden_size": 2048, "num_attention_heads": 16,
    "num_key_value_heads": 16, "vocab_size": 163840,
    "intermediate_size": 11264, "moe_intermediate_size": 1408,
    "n_routed_experts": 64, "num_experts_per_tok": 6, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "rms_norm_eps": 1e-5,
    "rope_theta": 50000, "routed_scaling_factor": 2.446,
    "scoring_func": "sigmoid", "tie_word_embeddings": False,
}


def fields(cfg):
    return dataclasses.asdict(cfg)


def nonzero(params, gen, scale=0.1):
    """Every RMSNorm scale and correction bias drawn nonzero (a fresh
    init's zeros would hide a wrong norm or a bias left out)."""
    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "router_bias"):
                v.copy_(torch.randn(v.shape, generator=gen) * scale)
    walk(params)
    return params


def small(**kw):
    return get_config("moonlight-16b-a3b").reduced(**kw)


def test_config_matches_the_published_model():
    cfg = get_config("moonlight-16b-a3b")
    got = {"num_hidden_layers": cfg.num_layers, "hidden_size": cfg.d_model,
           "num_attention_heads": cfg.num_heads,
           "num_key_value_heads": cfg.num_kv_heads,
           "vocab_size": cfg.vocab_size, "intermediate_size": cfg.dense_ff,
           "moe_intermediate_size": cfg.d_ff,
           "n_routed_experts": cfg.num_experts,
           "num_experts_per_tok": cfg.experts_per_token,
           "n_shared_experts": cfg.num_shared_experts,
           "first_k_dense_replace": cfg.first_k_dense,
           "kv_lora_rank": cfg.kv_lora_rank,
           "qk_nope_head_dim": cfg.qk_nope_head_dim,
           "qk_rope_head_dim": cfg.qk_rope_head_dim,
           "v_head_dim": cfg.v_head_dim, "rms_norm_eps": cfg.norm_eps,
           "rope_theta": cfg.rope_theta,
           "routed_scaling_factor": cfg.routed_scaling,
           "scoring_func": cfg.router_score,
           "tie_word_embeddings": cfg.tie_embeddings}
    assert got == PUBLISHED
    assert cfg.head_dim == 192 and cfg.num_held == 64 and cfg.drop_free
    assert cfg.num_full_periods == 26 and cfg.num_remainder_layers == 0
    assert set(port_archs()) - set(list_archs()) == {"moonlight-16b-a3b"}
    red = cfg.reduced()
    assert red.num_full_periods == 2 and 0 < red.num_held < red.num_experts
    red.validate()


def test_layer_kinds_and_settings_outside_the_fields():
    """Layer 0 is of kind ``MLA_DENSE`` (``params["first"]``), the rest
    ``MLA``; the leading layer, the embedding scale and the final norm's
    eps are settings of the class, not fields, so the JAX package's ten
    keep their fields and these defaults."""
    cfg = get_config("moonlight-16b-a3b")
    assert [cfg.layer_kind(i) for i in range(3)] == [MLA_DENSE, MLA, MLA]
    assert cfg.first_kind == MLA_DENSE and not cfg.embed_scale
    names = ("first_kind", "embed_scale")
    for arch in list_archs():
        c = get_config(arch)
        assert c.first_kind is None and c.embed_scale and c.norm_eps == 1e-6
        assert not set(names + ("norm_eps",)) & {
            f.name for f in dataclasses.fields(c)}
    params = T.init(torch.Generator().manual_seed(0), small())
    assert "router" not in params["first"]["ffn"]
    assert "router_bias" in params["blocks"]["layer0"]["ffn"]


def test_serving_and_sharding_refuse_latent_attention():
    from repro_torch.launch.shardings import make_ctx
    cfg = small()
    with pytest.raises(NotImplementedError, match="latent KV cache"):
        T.init_cache(cfg, 1, 8, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="latent attention"):
        make_ctx(cfg, None)


def test_attention_plain_route_at_the_head_pair():
    """``ops.attention`` on the CPU at q/k 192, v 128 and scale
    1/sqrt(192) against the softmax written out."""
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(2, 3, 17, 192, generator=g) for _ in range(2))
    v = torch.randn(2, 3, 17, 128, generator=g)
    out = ops.attention(q, k, v, causal=True, scale=1 / math.sqrt(192))
    s = q @ k.transpose(-1, -2) / math.sqrt(192)
    s = s.masked_fill(~torch.ones(17, 17, dtype=torch.bool).tril(), -1e30)
    torch.testing.assert_close(out, torch.softmax(s, -1) @ v, atol=1e-6,
                               rtol=1e-5)
    assert out.shape == (2, 3, 17, 128)


def layer_case(seed, **kw):
    cfg = small(**kw)
    gen = torch.Generator().manual_seed(seed)
    params = nonzero(T.init(gen, cfg), gen)
    return cfg, params, gen


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def test_mla_layer_matches_reference_with_gradients():
    """The MLA layer (and the MoE after it) forward and every gradient
    against the reference, f32: the outputs to 1e-5, the gradients to
    1e-5 of each leaf's largest."""
    cfg, params, gen = layer_case(1)
    p = T._index(params["blocks"], 0)["layer0"]
    c = fields(cfg)
    x = torch.randn(2, 12, cfg.d_model, generator=gen)
    q_pos = torch.arange(12)[None]
    ps = [v.requires_grad_(True) for _, v in leaves(p)]
    xs = x.clone().requires_grad_(True)
    got = A.mla_layer(p, cfg, xs, q_pos, dense=False)
    want = R.layer(p, x.clone().requires_grad_(True), c)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    dy = torch.randn(got.shape, generator=gen)
    g1 = torch.autograd.grad(got, ps, dy, allow_unused=True)
    xr = x.clone().requires_grad_(True)
    g2 = torch.autograd.grad(R.layer(p, xr, c), ps, dy, allow_unused=True)
    for (name, _), a, b in zip(leaves(p), g1, g2):
        if b is None:
            assert a is None or not a.any(), name
            continue
        # f32 sums over the batch's rows in another order: 1e-5 of the
        # leaf's largest gradient
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()),
                                   rtol=1e-4, msg=name)
    # the dense first layer too
    pf = params["first"]
    torch.testing.assert_close(A.mla_layer(pf, cfg, x, q_pos, dense=True),
                               R.layer(pf, x, c), atol=1e-5, rtol=1e-5)


def test_sigmoid_router_hand_case():
    """The choice follows s + b, the weights s: expert 1 has the larger
    score but the bias lifts expert 2 over it; ties go to the lower
    index; the weights are the chosen scores normalised, times the
    scaling."""
    logits = torch.tensor([[0.5, 2.0, 1.5, 1.5]])
    bias = torch.tensor([0.0, 0.0, 0.3, 0.0])
    w, ex = M.sigmoid_routing(logits, bias, 2, 2.446)
    s = torch.sigmoid(logits)[0]
    assert ex.tolist() == [[2, 1]]
    torch.testing.assert_close(w[0], torch.stack([s[2], s[1]])
                               / (s[1] + s[2]) * 2.446)
    _, ex = M.sigmoid_routing(logits, torch.zeros(4), 2, 1.0)
    assert ex.tolist() == [[1, 2]]          # 2 and 3 tie: the lower
    _, ex = M.sigmoid_routing(torch.zeros(1, 4), torch.zeros(4), 3, 1.0)
    assert ex.tolist() == [[0, 1, 2]]


def test_drop_free_at_total_imbalance():
    """A bias that sends every token to the held experts 0 and 1: no
    assignment is dropped, the counters see them all, and the layer is
    the reference's."""
    cfg, params, gen = layer_case(2)
    p = dict(T._index(params["blocks"], 0)["layer0"]["ffn"])
    p["router_bias"] = torch.tensor([9.0, 8.0] + [0.0] * 6)
    x = torch.randn(3, 20, cfg.d_model, generator=gen)
    tr = LayerTrace()
    got = M.moe_ffn_held(p, cfg, x, tr)
    torch.testing.assert_close(got, R.moe(p, x, fields(cfg)), atol=1e-5,
                               rtol=1e-5)
    held, load = tr.moe[0]
    assert int(held) == 2 * 60 and int(load) == 60


def test_eight_shares_add_up_to_the_whole_layer():
    """64 experts over 8 shares of 8: the held parts of all 8 shares, with
    the shared experts counted once, equal the uncut reference layer, to
    f32 rounding (8 partial sums added in another order: 1e-5 of the
    output's size)."""
    cfg = small(num_experts=64, experts_per_token=6, experts_held=8)
    gen = torch.Generator().manual_seed(3)
    full = dataclasses.replace(cfg, experts_held=64)
    p = T._index(nonzero(T.init(gen, full), gen)["blocks"], 0)["layer0"][
        "ffn"]
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    shared = R.swiglu(p["shared"], x.reshape(-1, cfg.d_model)).reshape(
        x.shape)
    total = shared.clone()
    for s in range(8):
        part = dataclasses.replace(cfg, expert_lo=8 * s)
        ps = {**p, **{n: p[n][8 * s:8 * s + 8]
                      for n in ("w_gate", "w_up", "w_down")}}
        total = total + M.moe_ffn_held(ps, part, x) - shared
    want = R.moe(p, x, fields(full))
    torch.testing.assert_close(total, want, atol=1e-5, rtol=1e-5)


def batch_of(cfg, gen, B=3, S=16):
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    w = torch.tensor([1.5, 0.0, 1.5])
    return toks, w


def test_federated_train_step_matches_reference():
    """``make_train_step(federated=True)`` on ``reduced()``: the loss, every
    leaf's gradient (read from the SGD step) and the counters against the
    reference's loss and autograd; the correction bias is left as it
    was."""
    cfg, params, gen = layer_case(4)
    toks, w = batch_of(cfg, gen)
    eta = 0.05
    step = make_train_step(cfg, eta=eta, federated=True)
    routing = []
    new, met = step(params, {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                             "schedule_weights": w}, routing=routing)
    ps = [v.detach().clone().requires_grad_(True) for _, v in leaves(params)]
    tree = _rebuild(params, ps)
    loss = R.loss(tree, fields(cfg), toks[:, :-1], toks[:, 1:], w)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    torch.testing.assert_close(met["loss"], loss.detach(), atol=1e-5,
                               rtol=1e-5)
    for (name, old), (_, nv), g in zip(leaves(params), leaves(new), grads):
        want = old if g is None else old - eta * g
        torch.testing.assert_close(nv, want, atol=1e-6, rtol=1e-5, msg=name)
    blocks = params["blocks"]["layer0"]["ffn"]
    assert torch.equal(new["blocks"]["layer0"]["ffn"]["router_bias"],
                       blocks["router_bias"])
    assert len(routing) == cfg.num_full_periods
    held = sum(int(((r >= 0) & (r < cfg.num_held)).sum()) for r in routing)
    assert int(met["moe_tokens_held"]) == held
    assert 0 < int(met["moe_load_max"]) <= toks[:, :-1].numel()


def _rebuild(tree, flat):
    it = iter(flat)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return walk(tree)


def test_layer_spans_and_backward_spans_nest():
    """With a live obs and remat, a step records ``lm.mla`` / ``lm.moe``
    (forward and recompute, the recompute's inside ``lm.moe_bwd``), the
    route and experts spans inside ``lm.moe``, and one ``lm.mla_bwd`` a
    layer and one ``lm.moe_bwd`` a MoE layer under ``lm.trunk_bwd``."""
    cfg, params, gen = layer_case(5, remat=True)
    toks, w = batch_of(cfg, gen)
    obs = Obs(enabled=True)
    step = make_train_step(cfg, eta=0.05, federated=True, obs=obs)
    step(params, {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                  "schedule_weights": w})
    spans = obs.tracer.spans()
    names = [s.name for s in spans]
    n_moe, n_layers = cfg.num_full_periods, cfg.num_layers
    assert names.count("lm.mla") == 2 * n_layers
    assert names.count("lm.moe") == 2 * n_moe
    assert names.count("lm.mla_bwd") == n_layers
    assert names.count("lm.moe_bwd") == n_moe
    assert names.count("lm.moe.route") == 2 * n_moe
    for s in spans:
        parent = spans[s.parent].name if s.parent is not None else None
        if s.name in ("lm.moe.route", "lm.moe.experts"):
            assert parent == "lm.moe"
        if s.name in ("lm.mla_bwd", "lm.moe_bwd"):
            assert parent == "lm.backward", parent
        if s.name == "lm.moe" and parent != "lm.trunk":
            assert parent == "lm.moe_bwd"


def test_reference_agrees_with_the_benchmark_copy():
    """One tiny step: the CPU tests' reference and the benchmark's
    (blocks of queries, a layer's gradient at a time) give one loss and
    one set of gradients, to f32 rounding."""
    sys.path.insert(0, str(ROOT))
    from portbench.reference import moonlight as B
    cfg, params, gen = layer_case(6)
    toks, w = batch_of(cfg, gen, S=20)
    m = fields(cfg)
    m.update(experts_held=cfg.num_held)
    loss_b, g_b, logs = B.loss_and_grads(params, m, toks, w)
    ps = [v.detach().clone().requires_grad_(True) for _, v in leaves(params)]
    loss_r = R.loss(_rebuild(params, ps), m, toks[:, :-1], toks[:, 1:], w)
    grads = torch.autograd.grad(loss_r, ps, allow_unused=True)
    lr = float(loss_r.detach())
    assert abs(loss_b - lr) <= 1e-5 * abs(lr)
    assert len(logs) == cfg.num_full_periods
    for (name, gb), g in zip(leaves(g_b), grads):
        want = torch.zeros_like(gb) if g is None else g
        torch.testing.assert_close(gb, want, atol=1e-6, rtol=1e-4, msg=name)


def test_chip_smoke_holds_the_cells_launches_and_bounds():
    """``chip_smoke.py``'s phase 8d at the benchmark cell's cut: a step
    launches K4 twice and K4-bwd once in each of the 27 layers and K7 once
    a head chunk of 512; the bounds at the (192, 128) pair count 2 (hd +
    hdv) and 2 (3 hd + 2 hdv) FLOPs a causal pair at the bf16 peak."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.roofline import PEAK_FLOPS
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b"), **C.MLA_CUT)
    assert C.train_step_launches(cfg, C.MLA_SEQ) == {
        "attention": 54, "attention_bwd": 27, "head_split": 8}
    B, H, S, hd, KV, T, hdv, kw = C.attn_dims(C.MLA_SHAPE)
    assert (hd, hdv, kw["scale"]) == (192, 128, 1 / math.sqrt(192))
    pairs = B * H * S * (S + 1) // 2
    for name, flops in (("attention", 2 * (hd + hdv)),
                        ("attention_bwd", 2 * (3 * hd + 2 * hdv))):
        ms, by = C.bound(name, C.MLA_SHAPE, 2)
        assert by == "operations"
        assert ms == pytest.approx(flops * pairs / PEAK_FLOPS * 1e3)
