"""The rest of the LM zoo against the JAX package: qwen2-7b (QKV bias),
yi-34b, gemma3-27b (QK norm, 5 local : 1 global), the three MoE configs,
musicgen-large (audio frames, sinusoidal positions) and
llama-3.2-vision-11b (gated cross attention over encoder states), each on
its ``reduced()`` config in f32 from converted JAX weights.

The JAX package initialises the QKV biases, the RMS-norm scales and the
cross layers' gate to zero (tanh(0) closes every cross layer), so a port
that got any of them wrong would pass on a fresh init: every such leaf is
set to seeded nonzero values before the weights are converted.

Tolerances, those of ``tests/test_torch_lm.py``: logits within 1e-4 x
max(1, max |logit|), cache leaves and layer outputs at 1e-5, greedy
tokens identical over 8 decode steps, integer cache fields equal, the
aux loss at 1e-5 relative."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build_model
from repro_torch.serve import generate
from repro_torch.serve import main as serve_main

ATOL = RTOL = 1e-5
LOGIT_TOL = 1e-4
AUX_RTOL = 1e-5
ZOO = ("qwen2-7b", "yi-34b", "gemma3-27b", "moonshot-v1-16b-a3b",
       "qwen3-moe-235b-a22b", "arctic-480b", "musicgen-large",
       "llama-3.2-vision-11b")
P, STEPS = 20, 8            # prompt, then greedy decode steps
CACHE_LEN = P + STEPS + 8
# leaves the JAX package initialises to zero
ZERO_INIT = ("gate", "bq", "bk", "bv", "scale")


def cfgs(arch, **kw):
    return j_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def nonzero(jp, seed=0):
    """The JAX params with every zero-initialised leaf (QKV biases, RMS
    norm scales, cross-attention gates) drawn N(0, 0.5) from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if getattr(path[-1], "key", None) in ZERO_INIT:
            return jnp.asarray(rng.normal(size=a.shape) * 0.5, a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(draw, jp)


@functools.lru_cache(maxsize=None)
def weights(arch, seed=0, **kw):
    """(JAX params with nonzero leaves, the port's converted params)."""
    jcfg, _ = cfgs(arch, **kw)
    jp = nonzero(JT.init(jax.random.key(seed), jcfg), seed)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def inputs(cfg, B, S, seed):
    """A prefill batch (numpy): tokens, or the audio family's frame
    embeddings; the VLM's encoder embeddings beside them."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        batch = {"frame_embeddings": rng.normal(
            size=(B, S, cfg.encoder_dim)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
    if cfg.family == "vlm":
        batch["encoder_embeddings"] = rng.normal(
            size=(B, cfg.num_encoder_tokens, cfg.encoder_dim)).astype(
                np.float32)
    return batch


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k == "tokens"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def close_logits(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= LOGIT_TOL * max(1.0, np.abs(want).max()), err


def close_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            close_tree(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=path)


def j_attention(params, cfg, x, **kw):
    """The reference's ``multihead_attention``, jitted (arrays in ``kw``
    traced, the rest static)."""
    arrays = {k: v for k, v in kw.items() if not isinstance(v, (bool, int))}
    static = {k: v for k, v in kw.items() if k not in arrays}
    return jax.jit(lambda p, x, a: JL.multihead_attention(
        p, cfg, x, **a, **static))(params, x, arrays)


def shapes(tree):
    return jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree)


# ---------------------------------------------------------------------------
# configs, init, conversion


@pytest.mark.parametrize("arch", ZOO)
def test_config_init_and_cache_match_reference(arch):
    """The config (full and reduced) equals the reference's; the port's
    own init has the reference's tree, shapes and dtypes (``gate`` a 0-d
    f32, the router f32), and its empty cache the reference's (a cross
    layer's fixed [B, num_encoder_tokens, KV, hd] keys and values)."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        j_get_config(arch))
    jcfg, tcfg = cfgs(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jp, _ = weights(arch)
    mine = TT.init(torch.Generator().manual_seed(0), tcfg)
    assert shapes(convert.lm_params_to_jax(mine)) == shapes(jp)
    close_tree(TT.init_cache(tcfg, 2, 40, "cpu"), JT.init_cache(jcfg, 2, 40))


@pytest.mark.parametrize("arch", ["arctic-480b", "rwkv6-3b"])
def test_init_draws_each_period_into_its_stack_slice(arch):
    """A period drawn into a NaN-filled slice of a stack writes every leaf
    with the numbers it draws whole and returns the slice's own tensors
    (nothing left beside the stack); ``init``'s stack holds the periods
    drawn whole one after the other from the same generator."""
    cfg = cfgs(arch)[1]
    fresh = TT.init_period(torch.Generator().manual_seed(3), cfg)
    stack = TT._map(lambda x: torch.full((2,) + tuple(x.shape), float("nan"),
                                         dtype=x.dtype), fresh)
    got = TT.init_period(torch.Generator().manual_seed(3), cfg,
                         out=TT._index(stack, 1))
    want, got, stack = flat(fresh), flat(got), flat(stack)
    for k, w in want.items():
        assert got[k].data_ptr() == stack[k][1].data_ptr(), k
        assert torch.equal(stack[k][1], w), k
        assert bool(stack[k][0].isnan().all()), k

    cfg = dataclasses.replace(cfg, num_layers=2 * len(cfg.block_pattern))
    gen = torch.Generator().manual_seed(5)
    TL.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                  dtype=getattr(torch, cfg.param_dtype))
    periods = [flat(TT.init_period(gen, cfg)) for _ in range(2)]
    blocks = flat(TT.init(torch.Generator().manual_seed(5), cfg)["blocks"])
    assert blocks.keys() == periods[0].keys()
    for k, b in blocks.items():
        assert torch.equal(b, torch.stack([p[k] for p in periods])), k


# the new leaves of the zoo and the configs whose reduced params hold them
NEW_LEAVES = {"bq": "qwen2-7b", "bk": "qwen2-7b", "bv": "qwen2-7b",
              "q_norm": "gemma3-27b", "k_norm": "gemma3-27b",
              "gate": "llama-3.2-vision-11b",
              "enc_proj": "llama-3.2-vision-11b",
              "embed_proj": "musicgen-large", "router": "arctic-480b",
              "w_gate": "arctic-480b", "w_up": "arctic-480b",
              "w_down": "arctic-480b", "shared": "moonshot-v1-16b-a3b",
              "dense_residual": "arctic-480b"}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conversion_round_trips_new_leaves(dtype):
    """``lm_params_from_jax`` then ``lm_params_to_jax`` gives back every
    leaf bit for bit (the biases, QK norms, the gate, the router, the
    experts, ``shared``, ``dense_residual``, ``embed_proj``,
    ``enc_proj``), in f32 and bf16 params; the f32 gate (a 0-d leaf a
    layer, stacked over the periods) and the f32 router keep their dtype
    in a bf16 model."""
    seen = set()
    for arch in sorted(set(NEW_LEAVES.values())):
        jcfg = j_get_config(arch).reduced(param_dtype=dtype, dtype=dtype)
        jp = nonzero(JT.init(jax.random.key(1), jcfg), 1)
        tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        back = flat(convert.lm_params_to_jax(tp))
        want = flat(jax.tree.map(np.asarray, jp))
        assert back.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_array_equal(back[path], np.asarray(w,
                                                                 np.float32),
                                          err_msg=path)
            assert back[path].shape == w.shape, path
        for path, leaf in flat(tp).items():
            parts = path.split("/")
            seen.update(p for p in parts if p in NEW_LEAVES)
            if parts[-1] in ("gate", "router"):
                assert leaf.dtype == torch.float32, path
            elif dtype == "bfloat16":
                assert leaf.dtype == torch.bfloat16, path
    assert seen == set(NEW_LEAVES)


# ---------------------------------------------------------------------------
# layers


def test_sinusoidal_positions():
    """At 1e-5 over the tests' positions; at position 3071 (the card's
    prompt) one last bit of a frequency (exp's rounding, which XLA and
    torch may take apart) moves the angle by up to 3071 x 2^-23 = 3.7e-4,
    the tolerance there."""
    for pos, atol in ((np.arange(64)[None, :], ATOL),
                      (np.array([[3000, 3071]]), 3071 * 2.0 ** -23)):
        for dim in (2, 64, 128):
            close(TL.sinusoidal_pos(t(pos), dim),
                  JL.sinusoidal_pos(jnp.asarray(pos), dim), atol=atol)


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-27b"])
def test_attention_bias_and_qk_norm(arch):
    """Prefill and a decode step into the ring buffer with QKV biases
    (qwen2-7b) or QK norm (gemma3-27b, its local window), nonzero."""
    jcfg, tcfg = cfgs(arch)
    jp = nonzero(JL.attention_params_init(jax.random.key(3), jcfg,
                                          jnp.float32), 3)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    window = jcfg.window_size
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 30, jcfg.d_model)).astype(np.float32)
    pos = np.arange(30)[None, :]
    jy, _, (jk, jv) = j_attention(jp, jcfg, jnp.asarray(x),
                                  q_pos=jnp.asarray(pos), window=window)
    ty, _, (tk, tv) = TL.multihead_attention(tp, tcfg, t(x), q_pos=t(pos),
                                             window=window)
    for g, w in ((ty, jy), (tk, jk), (tv, jv)):
        close(g, w)
    n = 24
    cache = {"k": rng.normal(size=(2, n, jcfg.num_kv_heads,
                                   jcfg.head_dim)).astype(np.float32),
             "v": rng.normal(size=(2, n, jcfg.num_kv_heads,
                                   jcfg.head_dim)).astype(np.float32),
             "slot_pos": np.arange(n, dtype=np.int32),
             "next_slot": np.int32(3)}
    x1 = x[:, :1]
    q_pos = np.full((2, 1), n, np.int32)
    jy, jc, _ = j_attention(jp, jcfg, jnp.asarray(x1),
                            q_pos=jnp.asarray(q_pos), window=window,
                            cache=jax.tree.map(jnp.asarray, cache))
    ty, tc, _ = TL.multihead_attention(
        tp, tcfg, t(x1), q_pos=t(q_pos), window=window,
        cache={k: t(v) for k, v in cache.items()})
    close(ty, jy)
    close_tree(tc, jc)


def test_gated_cross_attention():
    """Cross attention of 20 queries over 16 encoder states (non-causal,
    no rope), gate 0.7, then a decode step over the fixed keys and values
    (nothing written), against the reference."""
    jcfg, tcfg = cfgs("llama-3.2-vision-11b")
    jp = JL.attention_params_init(jax.random.key(5), jcfg, jnp.float32,
                                  cross=True)
    jp["gate"] = jnp.asarray(0.7, jnp.float32)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["gate"].dim() == 0
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 20, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    jy, _, (jk, jv) = j_attention(jp, jcfg, jnp.asarray(x),
                                  kv_x=jnp.asarray(enc), causal=False)
    ty, none, (tk, tv) = TL.multihead_attention(tp, tcfg, t(x), kv_x=t(enc),
                                                causal=False)
    assert none is None
    for g, w in ((ty, jy), (tk, jk), (tv, jv)):
        close(g, w)
    cache = {"k": np.asarray(jk), "v": np.asarray(jv)}
    jy, jc, _ = j_attention(jp, jcfg, jnp.asarray(x[:, :1]), causal=False,
                            cache=jax.tree.map(jnp.asarray, cache),
                            cache_fixed_kv=True)
    tcache = {k: t(v) for k, v in cache.items()}
    ty, tc, _ = TL.multihead_attention(tp, tcfg, t(x[:, :1]), causal=False,
                                       cache=tcache, cache_fixed_kv=True)
    close(ty, jy)
    assert tc is tcache


# ---------------------------------------------------------------------------
# the whole model: prefill, then decode


@functools.lru_cache(maxsize=None)
def j_serving(arch):
    """The reference's prefill of P positions, and its logits over 8
    decode steps (greedy tokens fed back; the audio family's frames
    drawn from a seed, the same for both packages)."""
    jcfg, _ = cfgs(arch)
    jp, _ = weights(arch)
    batch = inputs(jcfg, 2, P, seed=2)
    logits, aux, cache = jax.jit(lambda p, b: JT.forward(
        p, jcfg, b, collect_cache=True, cache_len=CACHE_LEN))(
            jp, as_jax(batch))
    step = jax.jit(lambda p, c, b: JT.serve_step(p, jcfg, c, b))
    frames = inputs(jcfg, 2, STEPS, seed=3).get("frame_embeddings")
    steps, c, last = [], cache, logits
    for i in range(STEPS):
        if frames is not None:
            b = {"frame_embeddings": jnp.asarray(frames[:, i:i + 1])}
        else:
            b = {"tokens": jnp.argmax(last[:, -1], -1)[:, None].astype(
                jnp.int32)}
        last, c = step(jp, c, b)
        steps.append(np.asarray(last))
    return batch, logits, aux, cache, steps, c, frames


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_logits_cache_and_aux(arch):
    _, tcfg = cfgs(arch)
    _, tp = weights(arch)
    batch, jl, jaux, jc, _, _, _ = j_serving(arch)
    tl, taux, tc = TT.forward(tp, tcfg, as_torch(batch), collect_cache=True,
                              cache_len=CACHE_LEN)
    assert tl.dtype == torch.float32
    close_logits(tl, jl)
    close_tree(tc, jc)
    if tcfg.num_experts:
        assert abs(float(taux) - float(jaux)) <= AUX_RTOL * float(jaux)
        assert float(jaux) > 0
    else:
        assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ZOO)
def test_decode_steps(arch):
    """8 decode steps after the prefill: greedy tokens fed back (the audio
    family: the seeded frames) give the reference's logits at every step,
    identical greedy tokens and the reference's final cache."""
    _, tcfg = cfgs(arch)
    _, tp = weights(arch)
    batch, _, _, _, jsteps, jc, frames = j_serving(arch)
    tl, _, tc = TT.forward(tp, tcfg, as_torch(batch), collect_cache=True,
                           cache_len=CACHE_LEN)
    for i, jl in enumerate(jsteps):
        tok = tl[:, -1].argmax(-1)
        if frames is not None:
            b = {"frame_embeddings": t(frames[:, i:i + 1])}
        else:
            b = {"tokens": tok[:, None]}
        tl, tc = TT.serve_step(tp, tcfg, tc, b)
        close_logits(tl, jl)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                      jl[:, -1].argmax(-1),
                                      err_msg=f"step {i}")
    close_tree(tc, jc)
    assert int(tc["pos"]) == P + STEPS


# ---------------------------------------------------------------------------
# entry points


def test_generate_passes_encoder_embeddings():
    """``serve.generate`` with the VLM's encoder embeddings gives the
    greedy tokens of a hand-run prefill + serve_step loop; an audio model
    refuses to decode."""
    jcfg, tcfg = cfgs("llama-3.2-vision-11b")
    _, tp = weights("llama-3.2-vision-11b")
    batch = as_torch(inputs(jcfg, 2, 18, seed=7))
    model = build_model(tcfg)
    out, stats = generate(model, tp, batch["tokens"], 5, temperature=0.0,
                          extra={"encoder_embeddings":
                                 batch["encoder_embeddings"]})
    logits, _, cache = model.forward(tp, batch, collect_cache=True,
                                     cache_len=31)
    want = [logits[:, -1].argmax(-1)]
    for _ in range(4):
        logits, cache = model.serve_step(tp, cache,
                                         {"tokens": want[-1][:, None]})
        want.append(logits[:, -1].argmax(-1))
    torch.testing.assert_close(out, torch.stack(want, 1))
    assert stats["launches_prefill"] == {} and stats["launches_decode"] == {}
    audio = build_model(get_config("musicgen-large").reduced())
    with pytest.raises(ValueError, match="audio decode"):
        generate(audio, None, batch["tokens"], 2)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "arctic-480b"])
def test_serve_cli_on_cpu(arch, capsys):
    """``python -m repro_torch.serve --arch ARCH --reduced --device cpu``
    (encoder embeddings drawn for the VLM); musicgen-large refuses."""
    serve_main(["--arch", arch, "--reduced", "--device", "cpu", "--gen",
                "4", "--prompt-len", "12"])
    out = capsys.readouterr().out
    assert f"{arch}-reduced on cpu" in out and "decode {}" in out
    with pytest.raises(SystemExit, match="audio decode"):
        serve_main(["--arch", "musicgen-large", "--reduced", "--device",
                    "cpu"])
