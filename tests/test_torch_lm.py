"""The port's LM serving path against the JAX package, on the reduced
configs (f32) of recurrentgemma-2b (3 layers, and 5 so that remainder
layers run) and rwkv6-3b, from converted JAX weights.

Tolerances: logits within 1e-4 * max(1, max |logit|), cache tensors and
layer outputs at atol 1e-5 / rtol 1e-5 (f32; both packages compute the
same f32 function in another summation order), greedy tokens identical,
integer cache fields equal.  Two stated exceptions: the RWKV WKV state
and time-mix output, where the port's step-by-step recurrence stands
against the JAX model's chunked log-space form (exp of cumulative log
decays), at rtol 1e-4 (one element of rwkv6's reduced prefill state is
1.1e-5 off at 0.07); and bf16 rope, where sin/cos round to bf16 in both
packages, at one bf16 step (8e-3 relative).

The bf16 case (the full configs' dtype) cannot be held to the JAX
package's bf16 logits at such tolerances: XLA and torch round bf16
intermediates in other places, and the two lie as far apart as each lies
from the f32 function.  It is held instead to the size of the
reference's own bf16 error: against the f32 function (the JAX package in
f32 on the same bf16 weights), the port's worst error over the prefill
and the decode steps stays within ``BF16_SPREAD`` times the JAX package's
in bf16."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_zoo import nonzero

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import layers as JL
from repro.models import rglru as JR
from repro.models import rwkv6 as JW
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from repro_torch.models import rwkv6 as TW
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build_model
from repro_torch.serve import generate

ATOL = RTOL = 1e-5
LOGIT_TOL = 1e-4
STATE_RTOL = 1e-4
# the port's worst readings reach 1.35x the reference's (recurrentgemma-2b
# at 5 layers); moving rms_norm's arithmetic from f32 to bf16 gives 1.55x
BF16_SPREAD = 1.5
CASES = {"rg3": ("recurrentgemma-2b", {}),
         "rg5": ("recurrentgemma-2b", {"num_layers": 5}),
         "rwkv": ("rwkv6-3b", {})}
# the bf16 check's cases: these and a dense, a QK-norm and an MoE config of
# the zoo (its zero-initialised leaves made nonzero, test_torch_zoo.nonzero)
BF16_CASES = {**CASES, "qwen2": ("qwen2-7b", {}),
              "gemma3": ("gemma3-27b", {}),
              "moonshot": ("moonshot-v1-16b-a3b", {})}


def cfgs(case):
    arch, kw = CASES[case]
    return j_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


@functools.lru_cache(maxsize=None)
def weights(case, seed=0):
    jcfg, tcfg = cfgs(case)
    jp = JT.init(jax.random.key(seed), jcfg)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def close_logits(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= LOGIT_TOL * max(1.0, np.abs(want).max()), err


def close_tree(got, want, path="", rtol=RTOL):
    """Every leaf of the port's cache against the JAX cache's."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            close_tree(got[k], want[k], f"{path}/{k}", rtol)
        return
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        r = STATE_RTOL if path.endswith("wkv") else rtol
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=r,
                                   err_msg=path)


def tokens(rng, cfg, B, S):
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and weights


def j_to_t(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def test_configs_and_registry_match_reference():
    """All ten architectures, and their reduced() forms, equal the
    reference's; the registry builds each."""
    assert list_archs() == j_list_archs() and len(list_archs()) == 10
    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            j_get_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) == \
            dataclasses.asdict(j_get_config(arch).reduced())
        assert build_model(arch).cfg is get_config(arch)
    for case in CASES:
        jcfg, tcfg = cfgs(case)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    moe = j_to_t(j_get_config("qwen3-moe-235b-a22b").reduced())
    assert build_model(moe).cfg == moe
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("case", list(CASES))
def test_init_structure_and_conversion(case):
    """The port's own init has the JAX init's tree, shapes and dtypes, and
    its empty cache the JAX package's; the conversion round-trips bit for
    bit."""
    jcfg, tcfg = cfgs(case)
    jp, tp = weights(case)
    mine = TT.init(torch.Generator().manual_seed(0), tcfg)
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    got = convert.lm_params_to_jax(mine)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), got) == shapes
    back = convert.lm_params_to_jax(tp)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, jp))
    close_tree(TT.init_cache(tcfg, 2, 40, "cpu"), JT.init_cache(jcfg, 2, 40))
    bf = jnp.asarray(np.arange(6, dtype=np.float32) / 3, jnp.bfloat16)
    tb = convert.lm_params_from_jax({"a": np.asarray(bf)}, device="cpu")
    assert tb["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        convert.lm_params_to_jax(tb)["a"], np.asarray(bf, np.float32))


# ---------------------------------------------------------------------------
# primitives and blocks


def test_norms_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    close(TL.rms_norm({"scale": t(scale)}, t(x)),
          JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    close(TL.group_norm(t(x), 4, scale=t(scale), bias=t(bias)),
          JL.group_norm(jnp.asarray(x), 4, scale=jnp.asarray(scale),
                        bias=jnp.asarray(bias)))
    close(TW.layer_norm({"scale": t(scale), "bias": t(bias)}, t(x)),
          JW.layer_norm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jnp.asarray(x)))
    q = rng.normal(size=(2, 50, 3, 32)).astype(np.float32)
    pos = np.arange(3000, 3050)[None, :]
    close(TL.rope(t(q), t(pos), 10_000.0),
          JL.rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0))
    got = TL.rope(t(q).to(torch.bfloat16), t(pos), 10_000.0)
    want = JL.rope(jnp.asarray(q, jnp.bfloat16), jnp.asarray(pos), 10_000.0)
    close(got, want, atol=1e-2, rtol=8e-3)


@pytest.mark.parametrize("S,window", [(40, 0), (40, 16), (2100, 16)])
def test_multihead_attention_prefill(S, window):
    """S = 2100 > 2048 is the JAX package's ``_chunked_attend`` with its
    windowed key span; the port sends every prefill to ops.attention."""
    jcfg, tcfg = cfgs("rg3")
    jp = JL.attention_params_init(jax.random.key(3), jcfg, jnp.float32)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(S + window)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None, :]
    jy, _, (jk, jv) = JL.multihead_attention(
        jp, jcfg, jnp.asarray(x), q_pos=jnp.asarray(pos), causal=True,
        window=window)
    ty, cache, (tk, tv) = TL.multihead_attention(
        tp, tcfg, t(x), q_pos=t(pos), causal=True, window=window)
    assert cache is None
    close(ty, jy)
    close(tk, jk)
    close(tv, jv)


def test_ring_buffer_decode_step():
    """One decode step into a wrapped ring buffer: written slot, slot
    positions, next slot and the output, against the JAX package."""
    jcfg, tcfg = cfgs("rg3")
    jp = JL.attention_params_init(jax.random.key(4), jcfg, jnp.float32)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    n, B = jcfg.window_size, 2
    kv = [rng.normal(size=(B, n, jcfg.num_kv_heads, jcfg.head_dim)).astype(
        np.float32) for _ in range(2)]
    slot_pos = np.array(list(range(32, 32 + n))[5:]
                        + list(range(32, 32 + n))[:5], np.int32)
    for nxt, p in ((5, 32 + n), (n - 1, 40)):
        cache = {"k": kv[0], "v": kv[1], "slot_pos": slot_pos,
                 "next_slot": np.int32(nxt)}
        x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        q_pos = np.full((B, 1), p, np.int32)
        jy, jc, _ = JL.multihead_attention(
            jp, jcfg, jnp.asarray(x), q_pos=jnp.asarray(q_pos), window=n,
            cache=jax.tree.map(jnp.asarray, cache))
        ty, tc, _ = TL.multihead_attention(
            tp, tcfg, t(x), q_pos=t(q_pos), window=n,
            cache={k: t(v) for k, v in cache.items()})
        close(ty, jy)
        close_tree(tc, jc)


@pytest.mark.parametrize("decode", [False, True])
def test_recurrent_block(decode):
    jcfg, tcfg = cfgs("rg3")
    jp = JR.recurrent_block_init(jax.random.key(5), jcfg, jnp.float32)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    T = 1 if decode else 37
    x = rng.normal(size=(2, T, jcfg.d_model)).astype(np.float32)
    lru = jcfg.lru_width
    state = {"h": rng.normal(size=(2, lru)).astype(np.float32),
             "conv": rng.normal(size=(2, jcfg.conv1d_width - 1,
                                      lru)).astype(np.float32)}
    jy, js = JR.recurrent_block(jp, jcfg, jnp.asarray(x),
                                jax.tree.map(jnp.asarray, state),
                                decode=decode)
    ty, ts = TR.recurrent_block(tp, tcfg, t(x),
                                {k: t(v) for k, v in state.items()},
                                decode=decode)
    close(ty, jy)
    close_tree(ts, js)


@pytest.mark.parametrize("decode", [False, True])
def test_time_mix_and_channel_mix(decode):
    jcfg, tcfg = cfgs("rwkv")
    k1, k2 = jax.random.split(jax.random.key(6))
    jp = {"tm": JW.time_mix_init(k1, jcfg, jnp.float32),
          "cm": JW.channel_mix_init(k2, jcfg, jnp.float32)}
    # nonzero mixing weights, so every stream of the ddlerp is exercised
    rng = np.random.default_rng(6)
    for blk, name in (("tm", "maa_x"), ("tm", "maa_rkvwg"), ("cm", "maa_k"),
                      ("cm", "maa_r")):
        jp[blk][name] = jnp.asarray(
            rng.uniform(0, 1, jp[blk][name].shape), jnp.float32)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    T = 1 if decode else 29
    d, H, hd = jcfg.d_model, jcfg.num_heads, jcfg.rwkv_head_dim
    x = rng.normal(size=(2, T, d)).astype(np.float32)
    shift = rng.normal(size=(2, d)).astype(np.float32)
    wkv = rng.normal(size=(2, H, hd, hd)).astype(np.float32) * 0.3
    fn_j = JW.time_mix_step if decode else JW.time_mix
    fn_t = TW.time_mix_step if decode else TW.time_mix
    jy, js, jw = fn_j(jp["tm"], jcfg, jnp.asarray(x), jnp.asarray(shift),
                      jnp.asarray(wkv))
    ty, ts, tw = fn_t(tp["tm"], tcfg, t(x), t(shift), t(wkv))
    close(ty, jy, rtol=STATE_RTOL)
    close(ts, js)
    close(tw, jw, rtol=STATE_RTOL)
    jy, js = JW.channel_mix(jp["cm"], jnp.asarray(x), jnp.asarray(shift))
    ty, ts = TW.channel_mix(tp["cm"], t(x), t(shift))
    close(ty, jy)
    close(ts, js)


# ---------------------------------------------------------------------------
# the whole model: prefill, then decode past the window


P, STEPS = 20, 24          # prompt, then decode past the window of 16
CACHE_LEN = P + STEPS + 8


@functools.lru_cache(maxsize=None)
def j_serving(case):
    """The JAX package's prefill of P tokens and its jitted serve_step."""
    jcfg, _ = cfgs(case)
    jp, _ = weights(case)
    toks = tokens(np.random.default_rng(2), jcfg, 2, P)
    logits, _, cache = jax.jit(lambda p, b: JT.forward(
        p, jcfg, b, collect_cache=True, cache_len=CACHE_LEN))(
            jp, {"tokens": jnp.asarray(toks)})
    step = jax.jit(lambda p, c, b: JT.serve_step(p, jcfg, c, b))
    return toks, logits, cache, step


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_and_cache(case):
    _, tcfg = cfgs(case)
    _, tp = weights(case)
    toks, jl, jc, _ = j_serving(case)
    tl, aux, tc = TT.forward(tp, tcfg, {"tokens": t(toks).long()},
                             collect_cache=True, cache_len=CACHE_LEN)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    close_logits(tl, jl)
    close_tree(tc, jc)
    tl2, _, none = TT.forward(tp, tcfg, {"tokens": t(toks).long()})
    assert none is None
    torch.testing.assert_close(tl2, tl, atol=0, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_serve_steps_past_the_window(case):
    """Prefill 20 tokens, then 24 greedy serve_steps (past the reduced
    window of 16, so the ring buffer wraps): the same logits, caches and
    greedy tokens as the JAX package at every step."""
    _, tcfg = cfgs(case)
    jp, tp = weights(case)
    toks, jl, jc, step = j_serving(case)
    tl, _, tc = TT.forward(tp, tcfg, {"tokens": t(toks).long()},
                           collect_cache=True, cache_len=CACHE_LEN)
    for i in range(STEPS):
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1))
        ttok = tl[:, -1].argmax(-1)
        np.testing.assert_array_equal(ttok.numpy(), jtok, err_msg=f"step {i}")
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(jtok[:, None],
                                                     jnp.int32)})
        tl, tc = TT.serve_step(tp, tcfg, tc, {"tokens": ttok[:, None]})
        close_logits(tl, jl)
    close_tree(tc, jc)
    assert int(tc["pos"]) == P + STEPS


def test_generate_entry_point_greedy_matches_serve_steps():
    """``serve.generate`` (the CLI's loop) gives the tokens of a hand-run
    prefill + serve_step loop, and launches no kernel on the CPU."""
    jcfg, tcfg = cfgs("rg5")
    _, tp = weights("rg5")
    model = build_model(tcfg)
    toks = torch.from_numpy(tokens(np.random.default_rng(3), jcfg, 2, 18))
    out, stats = generate(model, tp, toks.long(), 6, temperature=0.0)
    logits, _, cache = model.forward(tp, {"tokens": toks.long()},
                                     collect_cache=True, cache_len=32)
    want = [logits[:, -1].argmax(-1)]
    for _ in range(5):
        logits, cache = model.serve_step(tp, cache,
                                         {"tokens": want[-1][:, None]})
        want.append(logits[:, -1].argmax(-1))
    torch.testing.assert_close(out, torch.stack(want, 1))
    assert stats["launches_prefill"] == {} and stats["launches_decode"] == {}
    g = torch.Generator().manual_seed(0)
    sampled, _ = generate(model, tp, toks.long(), 4, temperature=0.8,
                          generator=g)
    assert sampled.shape == (2, 4)
    assert int(sampled.max()) < tcfg.vocab_size


# ---------------------------------------------------------------------------
# bf16


def bf16_spread(got, want):
    """(max abs error over max(1, max |want|), relative L2 error)."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    return np.array([np.abs(got - want).max() / max(1.0, np.abs(want).max()),
                     np.linalg.norm(got - want) / np.linalg.norm(want)])


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_serving_error_within_the_references(case):
    """bf16 weights and activations, prefill of 20 tokens then 24
    teacher-forced serve_steps past the window: the port's logits lie no
    further from the f32 function (the JAX package in f32 on the same
    weights) than BF16_SPREAD times the JAX package's own bf16 logits do,
    in max abs error over scale and in relative L2, worst over the prefill
    and every step."""
    arch, kw = BF16_CASES[case]
    bf = {"dtype": "bfloat16", "param_dtype": "bfloat16"}
    jcfg, tcfg = (get(arch).reduced(**kw, **bf)
                  for get in (j_get_config, get_config))
    fcfg = j_get_config(arch).reduced(**kw)
    jp = JT.init(jax.random.key(0), jcfg)
    if case not in CASES:
        jp = nonzero(jp)
    fp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    toks = tokens(np.random.default_rng(2), jcfg, 2, P + STEPS)
    b = {"tokens": jnp.asarray(toks[:, :P])}
    jl, _, jc = jax.jit(lambda p, b: JT.forward(
        p, jcfg, b, collect_cache=True, cache_len=CACHE_LEN))(jp, b)
    fl, _, fc = jax.jit(lambda p, b: JT.forward(
        p, fcfg, b, collect_cache=True, cache_len=CACHE_LEN))(fp, b)
    tl, _, tc = TT.forward(tp, tcfg, {"tokens": t(toks[:, :P]).long()},
                           collect_cache=True, cache_len=CACHE_LEN)
    assert tl.dtype == torch.float32
    port, ref = [bf16_spread(tl, fl)], [bf16_spread(jl, fl)]
    jstep = jax.jit(lambda p, c, b: JT.serve_step(p, jcfg, c, b))
    fstep = jax.jit(lambda p, c, b: JT.serve_step(p, fcfg, c, b))
    for i in range(P, P + STEPS):
        tok = toks[:, i:i + 1]
        jl, jc = jstep(jp, jc, {"tokens": jnp.asarray(tok)})
        fl, fc = fstep(fp, fc, {"tokens": jnp.asarray(tok)})
        tl, tc = TT.serve_step(tp, tcfg, tc, {"tokens": t(tok).long()})
        assert bool(torch.isfinite(tl).all())
        port.append(bf16_spread(tl, fl))
        ref.append(bf16_spread(jl, fl))
    port, ref = np.max(port, axis=0), np.max(ref, axis=0)
    print(f"{case} bf16 vs f32, max err x scale and rel L2: port {port}, "
          f"reference {ref}, ratio {port / ref}")
    assert (port <= BF16_SPREAD * ref).all(), (port, ref)
