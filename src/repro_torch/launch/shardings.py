"""Parameter / input / cache sharding rules for the production mesh
(counterpart of ``repro/launch/shardings.py``), as DTensor placements.

Two regimes per architecture:

* **Megatron TP + sequence-parallel residual** when attention heads and
  d_ff divide the model axis (gemma3, moonshot, qwen3-moe, musicgen,
  llama-vision): heads/d_ff/experts/vocab column-parallel, residual
  stream sequence-sharded between layers.

* **FSDP + context parallelism** otherwise (qwen2 28H, yi 56H, arctic
  56H, recurrentgemma 10H, rwkv6 40H): parameters stored sharded over
  (data x model) and gathered where used; compute is token-parallel with
  queries sequence-sharded and the (small, GQA) keys and values whole.

MoE expert tables are always expert-sharded over 'model' + FSDP over
'data' (matching ``models.moe``'s expert-parallel path).  Decode KV
caches shard kv-heads over 'model' when divisible, else cache length;
batch-1 decode shards cache length over the idle batch axes too.

Each rule gives the reference's PartitionSpec entries (``_param_rule``);
``param_shardings`` / ``batch_shardings`` / ``cache_shardings`` turn them
into one placement a mesh dim (``sharding.spec_to_placements``).  The
specs of ``input_specs`` / ``param_specs`` / ``cache_specs`` are meta
tensors (shapes and dtypes, no memory, no numbers drawn).  The rules read
only the mesh's dim names and sizes, so they run on a stand-in mesh with
no process group.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shapes import CACHE_PAD, InputShape
from repro_torch.models import transformer as T
from repro_torch.sharding import ShardingCtx, axis_sizes, spec_to_placements


def tp_capable(cfg: ModelConfig, model_axis_size: int = 16) -> bool:
    if cfg.num_heads and cfg.num_heads % model_axis_size != 0:
        return False
    if cfg.d_ff and cfg.d_ff % model_axis_size != 0:
        return False
    return True


def make_ctx(cfg: ModelConfig, mesh, shape: Optional[InputShape] = None,
             opt: bool = False) -> ShardingCtx:
    sizes = axis_sizes(mesh)
    multi_pod = "pod" in sizes
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    m = sizes["model"]
    tp = tp_capable(cfg, m)
    # opt: context-parallel attention (weights FSDP'd over data, queries
    # sequence-sharded, GQA KV whole) for train and prefill; decode keeps
    # the plain rules (one token a step would re-gather FSDP weights)
    hybrid = opt and (shape is None or shape.kind in ("train", "prefill"))
    seq_axes = []
    if shape is not None and shape.kind in ("decode", "prefill"):
        # prefill also outputs a cache of seq_len: shard it the same way
        if shape.global_batch == 1:
            seq_axes += ["pod", "data"] if multi_pod else ["data"]
        if not (tp and cfg.num_kv_heads % m == 0):
            seq_axes.append("model")
    return ShardingCtx(mesh=mesh, batch_axes=batch_axes, model_axis="model",
                       fsdp_axes=("data",), seq_axes=tuple(seq_axes), tp=tp,
                       hybrid=hybrid)


# ---------------------------------------------------------------------------
# parameter shardings


def _param_rule(path: str, shape, cfg: ModelConfig, ctx: ShardingCtx):
    """PartitionSpec entries (a tuple, one a dim) for a (possibly
    period-stacked) param leaf at ``path`` ("blocks/layer0/attn/wq")."""
    sizes = axis_sizes(ctx.mesh)
    m = ctx.model_axis
    msize = sizes[m]
    dsize = sizes["data"]
    dm = ("data", m)
    dmsize = dsize * msize
    tp = ctx.tp
    name = path.split("/")[-1]

    stacked = path.startswith("blocks/")
    dims = list(shape[1:]) if stacked else list(shape)
    spec = [None] * len(dims)

    def fsdp_largest():
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if dims[i] >= 1024 and dims[i] % dmsize == 0:
                spec[i] = dm
                return
        for i in order:
            if dims[i] >= 1024 and dims[i] % dsize == 0:
                spec[i] = "data"
                return

    if name == "embed":
        # vocab over model and d over data
        spec[0] = m if dims[0] % msize == 0 else None
        if dims[1] % dsize == 0:
            spec[1] = "data"
    elif name == "lm_head":
        spec[1] = m if dims[1] % msize == 0 else None
    elif name in ("wq", "wk", "wv", "wo") and len(dims) == 3:
        if ctx.hybrid:
            # context-parallel attention: weights only storage-sharded
            if dims[0] % dsize == 0:
                spec[0] = "data"
            elif dims[2] % dsize == 0:
                spec[2] = "data"
        elif tp and name != "wo" and dims[1] % msize == 0:
            spec[1] = m
        elif tp and name == "wo" and dims[0] % msize == 0:
            spec[0] = m
        else:
            fsdp_largest()
    elif name in ("w_gate", "w_up", "w_down") and len(dims) == 3 \
            and cfg.num_experts and dims[0] == cfg.num_experts:
        # MoE expert tables: expert-sharded + FSDP (as models.moe)
        spec[0] = m
        fd = 1 if name in ("w_gate", "w_up") else 2
        if dims[fd] % dsize == 0:
            spec[fd] = "data"
    elif name in ("w_gate", "w_up", "w_in", "W_k") and len(dims) == 2:
        if tp and not ctx.hybrid and dims[1] % msize == 0:
            spec[1] = m   # column parallel
        else:
            fsdp_largest()
    elif name in ("w_down", "w_out", "w_o", "W_v", "W_o") and len(dims) == 2:
        if tp and not ctx.hybrid and dims[0] % msize == 0:
            spec[0] = m   # row parallel
        else:
            fsdp_largest()
    elif name in ("W_r", "W_g", "w_x", "W_i") and len(dims) == 2:
        fsdp_largest()
    elif len(dims) >= 2 and max(dims) * min(dims) >= (1 << 22):
        fsdp_largest()

    if stacked:
        spec = [None] + spec
    return tuple(spec)


def _map_path(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_shardings(params_spec, cfg: ModelConfig, ctx: ShardingCtx):
    """A tree of placements (one a mesh dim) matching ``params_spec``
    (``param_specs(cfg)`` or real params)."""
    return _map_path(
        lambda path, leaf: spec_to_placements(
            ctx.mesh, _param_rule(path, leaf.shape, cfg, ctx)),
        params_spec)


# ---------------------------------------------------------------------------
# activations / batch / cache


def _shardable(dim, sizes, axes):
    n = 1
    for a in axes:
        n *= sizes[a]
    return dim % n == 0 and n > 1


def batch_spec_of(shape, ctx: ShardingCtx) -> tuple:
    """A batch leaf's spec: dim 0 over the batch axes where they divide
    it."""
    sizes = axis_sizes(ctx.mesh)
    ba = ctx.batch_axes
    spec = [None] * len(shape)
    if len(shape) and _shardable(shape[0], sizes, ba):
        spec[0] = ba if len(ba) > 1 else ba[0]
    return tuple(spec)


def batch_shardings(batch_spec, ctx: ShardingCtx):
    return _map_path(
        lambda path, leaf: spec_to_placements(
            ctx.mesh, batch_spec_of(leaf.shape, ctx)), batch_spec)


def _cache_rule(path: str, shape, cfg: ModelConfig, ctx: ShardingCtx):
    sizes = axis_sizes(ctx.mesh)
    ba = ctx.batch_axes
    m = ctx.model_axis
    seq = ctx.seq_axes
    kv_heads_sharded = ctx.tp and cfg.num_kv_heads % sizes[m] == 0
    stacked = path.startswith("blocks/")
    shape = shape[1:] if stacked else shape
    name = path.split("/")[-1]
    spec = [None] * len(shape)
    if name in ("k", "v") and len(shape) == 4:
        B, n, KV, hd = shape
        if _shardable(B, sizes, ba):
            spec[0] = ba if len(ba) > 1 else ba[0]
        if seq and _shardable(n, sizes, seq):
            spec[1] = tuple(seq) if len(seq) > 1 else seq[0]
        if kv_heads_sharded:
            spec[2] = m
    elif name in ("wkv", "shift1", "shift2", "h", "conv") and len(shape):
        if _shardable(shape[0], sizes, ba):
            spec[0] = ba if len(ba) > 1 else ba[0]
    if stacked:
        spec = [None] + spec
    return tuple(spec)


def cache_shardings(cache_spec, cfg: ModelConfig, ctx: ShardingCtx):
    return _map_path(
        lambda path, leaf: spec_to_placements(
            ctx.mesh, _cache_rule(path, leaf.shape, cfg, ctx)), cache_spec)


# ---------------------------------------------------------------------------
# meta stand-ins (no allocation: the dry run's inputs)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape, federated: bool = False):
    """Meta tensors for every model input of this (arch, shape)."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    i64 = torch.int64
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), i64)}
        if cfg.family == "audio":
            batch.pop("tokens")
            batch["frame_embeddings"] = _meta((B, S, cfg.encoder_dim), dt)
        if cfg.family == "vlm":
            batch["encoder_embeddings"] = _meta(
                (B, cfg.num_encoder_tokens, cfg.encoder_dim), dt)
        if shape.kind == "train":
            batch["targets"] = _meta((B, S), i64)
            if federated:
                batch["schedule_weights"] = _meta((B,), torch.float32)
        return batch
    # decode: one token + a cache of seq_len
    batch = {"tokens": _meta((B, 1), i64)}
    if cfg.family == "audio":
        batch.pop("tokens")
        batch["frame_embeddings"] = _meta((B, 1, cfg.encoder_dim), dt)
    return batch


def param_specs(cfg: ModelConfig):
    """The params of ``T.init`` as meta tensors: ``init`` runs under
    ``FakeTensorMode`` (no memory, no numbers drawn) and each leaf's
    shape and dtype become a meta tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = T.init(torch.Generator(), cfg)
    return T._map(lambda x: _meta(x.shape, x.dtype), params)


def cache_specs(cfg: ModelConfig, shape: InputShape):
    return T.init_cache(cfg, shape.global_batch, shape.seq_len + CACHE_PAD,
                        "meta")
