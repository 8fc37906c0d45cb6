"""Ranks of the sharded CPU tests (``tests/test_torch_sharded.py``).

``python tests/_torch_sharded_ranks.py CASE DIR WORLD`` spawns WORLD gloo
ranks (``torch.multiprocessing.spawn``, a process group through a file in
DIR); each runs CASE on its mesh, and rank 0 writes what the test
compares to DIR/out.pt.  The inputs come from DIR/in.pt (written by the
test) or are drawn here from a seed, the same on every rank.  No JAX
here: the reference's numbers are computed by the test itself.
"""
import dataclasses
import os
import sys

import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fl.distributed import make_train_step  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.shapes import InputShape  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import (ShardingCtx, as_dtensor,  # noqa: E402
                                  full_tree, shard_tree, spec_to_placements)


def case_fed(tmp):
    """The weighted federated step on a 2x2x2 pod mesh (the reference's
    ``test_federated_step_weighted_aggregation`` ctx)."""
    inp = torch.load(os.path.join(tmp, "in.pt"))
    cfg = get_config("qwen2-7b").reduced()
    mesh = make_debug_mesh(2, 2, multi_pod=True)
    ctx = ShardingCtx(mesh=mesh, batch_axes=("pod", "data"),
                      model_axis="model", fsdp_axes=("data",), tp=False)
    params = inp["params"]
    P = shard_tree(params, SH.param_shardings(params, cfg, ctx), mesh)
    batch = inp["batch"]
    Bt = shard_tree(batch, SH.batch_shardings(batch, ctx), mesh)
    new, metrics = make_train_step(cfg, eta=0.1, federated=True,
                                   ctx=ctx)(P, Bt)
    return {"params": full_tree(new),
            "metrics": {k: v.clone() for k, v in metrics.items()}}


def case_moe(tmp):
    """Expert-parallel MoE on data 4 x model 2 (E = 4 experts over 2
    model ranks)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    inp = torch.load(os.path.join(tmp, "in.pt"))
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              capacity_factor=8.0)
    mesh = make_debug_mesh(4, 2)
    ctx = ShardingCtx(mesh=mesh, batch_axes=("data",), model_axis="model",
                      fsdp_axes=(), tp=True)
    experts = spec_to_placements(mesh, ("model", None, None))
    rep = (Replicate(), Replicate())
    pl = {k: (experts if k in ("w_gate", "w_up", "w_down") else rep)
          for k in inp["params"]}
    P = shard_tree(inp["params"], pl, mesh)
    X = shard_tree(inp["x"], (Shard(0), Replicate()), mesh)
    y, aux = M.moe_ffn(P, cfg, X, ctx)
    assert isinstance(y, DTensor)
    return {"y": y.full_tensor(), "aux": aux.full_tensor()}


FAMILIES = {
    # name: (arch, ctx changes)
    "dense_tp": ("gemma3-27b", {}),
    "context_parallel": ("qwen2-7b", {"tp": False}),
    "hybrid": ("yi-34b", {"hybrid": True}),
    "rwkv6": ("rwkv6-3b", {}),
    "recurrentgemma": ("recurrentgemma-2b", {}),
    "moe": ("moonshot-v1-16b-a3b", {}),
    "vlm_cross": ("llama-3.2-vision-11b", {}),
}


def _nonzero(params, gen):
    """Every all-zero leaf (norm scales, biases, gates) drawn N(0, 0.25),
    so that a wrong placement of one cannot hide."""
    return T._map(lambda x: (torch.randn(x.shape, generator=gen) * 0.25)
                  .to(x.dtype) if not x.any() else x, params)


def family_inputs(arch):
    cfg = get_config(arch).reduced()
    if cfg.num_experts:
        # no assignment dropped: each rank's capacity is of its own tokens
        cfg = dataclasses.replace(cfg, capacity_factor=float(
            cfg.num_experts))
    gen = torch.Generator().manual_seed(0)
    params = _nonzero(T.init(gen, cfg), gen)
    B, S = 8, 16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen),
             "targets": torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=gen)}
    if cfg.family == "vlm":
        batch["encoder_embeddings"] = torch.randn(
            (B, cfg.num_encoder_tokens, cfg.encoder_dim), generator=gen)
    return cfg, params, batch


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def case_families(tmp):
    """Each family's forward logits and loss, and a train step (its new
    params' largest difference and its gradient norm), sharded on data 4
    x model 2 by the production rules, beside the unsharded port's."""
    mesh = make_debug_mesh(4, 2)
    out = {}
    for name, (arch, changes) in FAMILIES.items():
        cfg, params, batch = family_inputs(arch)
        shape = InputShape("debug", 16, 8, "train")
        ctx = dataclasses.replace(SH.make_ctx(cfg, mesh, shape), **changes)
        P = shard_tree(params, SH.param_shardings(params, cfg, ctx), mesh)
        Bt = shard_tree(batch, SH.batch_shardings(batch, ctx), mesh)
        with torch.no_grad():
            logits, aux, _ = T.forward(P, cfg, Bt, ctx=ctx)
            loss, _ = T.loss_fn(P, cfg, Bt, ctx=ctx)
            ref_logits, ref_aux, _ = T.forward(params, cfg, batch)
            ref_loss, _ = T.loss_fn(params, cfg, batch)
        new, m = make_train_step(cfg, eta=0.1, ctx=ctx)(P, Bt)
        ref_new, ref_m = make_train_step(cfg, eta=0.1)(params, batch)
        step_err = max(float((a - b).abs().max()) for a, b in zip(
            _leaves(full_tree(new)), _leaves(ref_new)))
        out[name] = full_tree({"logits": logits, "loss": loss, "aux": aux,
                               "ref_logits": ref_logits,
                               "ref_loss": ref_loss, "ref_aux": ref_aux,
                               "grad_norm": m["grad_norm"],
                               "ref_grad_norm": ref_m["grad_norm"]})
        out[name]["step_err"] = step_err
    return out


SERVE = {
    # name: (arch, batch, ctx changes for prefill and decode); the
    # context-parallel ones take the full-size qwen2-7b's rules (its 28
    # heads do not divide the model axis, so the cache length is split)
    "context_parallel": ("qwen2-7b", 8, {"tp": False,
                                         "seq_axes": ("model",)}),
    "context_parallel_batch1": ("qwen2-7b", 1, {
        "tp": False, "seq_axes": ("data", "model")}),
    "dense_tp": ("gemma3-27b", 8, {}),
    "dense_tp_batch1": ("gemma3-27b", 1, {}),
}


def _placed(tree, placements, mesh):
    """Each leaf of ``tree`` (a DTensor or a plain tensor, taken as
    replicated) redistributed to its placements."""
    if isinstance(tree, dict):
        return {k: _placed(tree[k], placements[k], mesh) for k in tree}
    return as_dtensor(tree, mesh).redistribute(mesh, placements)


def case_serve(tmp):
    """A sharded prefill, then decode steps on the cache at the decode
    placements (``cache_shardings``: its length split over "seq" where
    the rules say so), on data 4 x model 2, beside the unsharded port:
    each step's logits and the final cache."""
    from torch.distributed.tensor import Shard
    from repro_torch.fl.distributed import (make_prefill_step,
                                            make_serve_step)
    mesh = make_debug_mesh(4, 2)
    out = {}
    for name, (arch, B, changes) in SERVE.items():
        cfg, params, batch = family_inputs(arch)
        pb = {"tokens": batch["tokens"][:B]}
        S = pb["tokens"].shape[1]
        n = S + 8

        def ctx_for(kind):
            shape = InputShape(kind, S, B, kind)
            return dataclasses.replace(SH.make_ctx(cfg, mesh, shape),
                                       **changes)
        pctx, dctx = ctx_for("prefill"), ctx_for("decode")
        P = shard_tree(params, SH.param_shardings(params, cfg, pctx), mesh)
        lg, cache = make_prefill_step(cfg, n, ctx=pctx)(
            P, shard_tree(pb, SH.batch_shardings(pb, pctx), mesh))
        rlg, rcache = make_prefill_step(cfg, n)(params, pb)
        cache = _placed(cache, SH.cache_shardings(cache, cfg, dctx), mesh)
        k0 = cache["blocks"]["layer0"]["k"] if "blocks" in cache \
            else cache["rem0"]["k"]
        errs = [float((lg.full_tensor() - rlg).abs().max())]
        for _ in range(4):
            db = {"tokens": rlg[:, -1].argmax(-1)[:, None]}
            lg, cache = make_serve_step(cfg, ctx=dctx)(
                P, cache, shard_tree(db, SH.batch_shardings(db, dctx), mesh))
            rlg, rcache = make_serve_step(cfg)(params, rcache, db)
            errs.append(float((lg.full_tensor() - rlg).abs().max()))
        got, want = _leaves(full_tree(cache)), _leaves(rcache)
        out[name] = {
            "logit_errs": errs,
            "cache_err": max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(got, want)
                             if b.is_floating_point()),
            "cache_ints_equal": all(torch.equal(a, b)
                                    for a, b in zip(got, want)
                                    if not b.is_floating_point()),
            "same_leaves": [tuple(a.shape) for a in got]
            == [tuple(b.shape) for b in want],
            # the stacked k [nper, B, n, KV, hd]: which dims are split
            "k_split_dims": sorted({p.dim for p in k0.placements
                                    if isinstance(p, Shard)}),
        }
    return out


def case_world_one(tmp):
    """On a one-rank (1, 1) mesh, the sharded train step, prefill and 8
    decode steps of the bf16 remat configs (tp as the production mesh
    picks it), next to the unsharded ones: {name: bitwise equal}."""
    from repro_torch.fl.distributed import (make_prefill_step,
                                            make_serve_step, silo_weights)
    mesh = make_debug_mesh(1, 1)
    out = {}
    for arch in ("qwen2-7b", "moonshot-v1-16b-a3b", "llama-3.2-vision-11b",
                 "recurrentgemma-2b", "rwkv6-3b"):
        cfg, params, batch = family_inputs(arch)
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  param_dtype="bfloat16", remat=True)
        params = T._map(lambda x: x.to(torch.bfloat16)
                        if x.dtype == torch.float32 and x.dim() else x,
                        params)
        B = batch["tokens"].shape[0]
        batch["schedule_weights"] = silo_weights([1, 0], 2) \
            .repeat_interleave(B // 2)
        tp = SH.tp_capable(get_config(arch), 16)

        def ctx_for(kind):
            shape = InputShape(kind, 16, B, kind)
            return dataclasses.replace(SH.make_ctx(cfg, mesh, shape), tp=tp)
        ctx = ctx_for("train")
        P = shard_tree(params, SH.param_shardings(params, cfg, ctx), mesh)
        Bt = shard_tree(batch, SH.batch_shardings(batch, ctx), mesh)
        new, m = make_train_step(cfg, eta=0.05, federated=True,
                                 ctx=ctx)(P, Bt)
        ref_new, ref_m = make_train_step(cfg, eta=0.05,
                                         federated=True)(params, batch)
        out[arch] = all(torch.equal(a, b) for a, b in zip(
            _leaves(full_tree(new)), _leaves(ref_new))) and all(
            torch.equal(m[k], ref_m[k]) for k in ref_m)
        if arch != "qwen2-7b":
            continue
        pctx, dctx = ctx_for("prefill"), ctx_for("decode")
        pb = {"tokens": batch["tokens"]}
        lg, cache = make_prefill_step(cfg, 24, ctx=pctx)(
            P, shard_tree(pb, SH.batch_shardings(pb, pctx), mesh))
        rlg, rcache = make_prefill_step(cfg, 24)(params, pb)
        same = torch.equal(lg.full_tensor(), rlg)
        for _ in range(8):
            db = {"tokens": rlg[:, -1].argmax(-1)[:, None]}
            lg, cache = make_serve_step(cfg, ctx=dctx)(
                P, cache, shard_tree(db, SH.batch_shardings(db, dctx), mesh))
            rlg, rcache = make_serve_step(cfg)(params, rcache, db)
            same &= torch.equal(lg.full_tensor(), rlg)
        out["qwen2-7b serve"] = same and all(torch.equal(a, b) for a, b in
                                             zip(_leaves(full_tree(cache)),
                                                 _leaves(rcache)))
    return out


CASES = {"fed": case_fed, "moe": case_moe, "families": case_families,
         "serve": case_serve, "world_one": case_world_one}


def rank_main(rank, case, tmp, world):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world)
    try:
        out = CASES[case](tmp)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, tmp, world = sys.argv[1], sys.argv[2], int(sys.argv[3])
    torch.multiprocessing.spawn(rank_main, args=(case, tmp, world),
                                nprocs=world, join=True)
