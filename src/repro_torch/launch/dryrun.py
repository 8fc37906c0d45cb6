"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``).

For an (architecture x input shape) the step (train / prefill / decode)
is traced once, in one process, as rank 0 of a ``"fake"`` process group
of 256 (16x16 mesh) or 512 (2x16x16) ranks: the params, inputs and
decode cache are meta tensors (shapes, no memory), distributed as
DTensors by ``launch.shardings``'s rules, and the step runs eagerly under
its ``ShardingCtx``.  The fake group's collectives move nothing; the
trace records, per device (``roofline.TraceCounter``): the local ops'
FLOPs, their unfused bytes, the collective bytes and counts by kind, and
the peak live bytes of the local storages.  Those feed ``roofline_terms``
at the H100's peaks.

The reference lowers a scanned program, whose cost analysis counts a
loop body once, so it extrapolates from unrolled one- and two-period
variants (its ``counting_pass``).  The eager trace here runs every layer,
so there is no extrapolation and no counterpart of ``counting_pass``;
``cost_analysis`` holds the trace's own counts.  The reference's
``compile_s`` is ``trace_s``, and ``memory_analysis`` holds only the
peak (no compiled executable has argument / temp / alias sizes).  The
collective term divides by one card's NVLink rate, while a 16x16 mesh of
H100s spans 32 hosts of 8: across hosts the links are slower, so the
term is a lower bound.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k [--multi-pod] [--opt] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.fl.distributed import (make_prefill_step, make_serve_step,
                                        make_train_step)
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (CACHE_PAD, SHAPES, InputShape,
                                       applicable_shapes)
from repro_torch.roofline import TraceCounter, model_flops, roofline_terms
from repro_torch.sharding import shard_tree


def fake_group(world: int) -> None:
    """Make the default process group a ``"fake"`` one of ``world``
    ranks, this process rank 0 (an earlier group of another size is
    destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def trace_step(cfg: ModelConfig, shape: InputShape, mesh, *,
               federated: bool = False, opt: bool = False):
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (meta tensors
    under the current process group) -> (ctx, TraceCounter, seconds)."""
    ctx = SH.make_ctx(cfg, mesh, shape, opt=opt)
    params = SH.param_specs(cfg)
    params = shard_tree(params, SH.param_shardings(params, cfg, ctx), mesh)
    batch = SH.input_specs(cfg, shape, federated=federated)
    batch = shard_tree(batch, SH.batch_shardings(batch, ctx), mesh)
    counter = TraceCounter()
    counter.track(params)
    counter.track(batch)
    cache = None
    if shape.kind == "decode":
        cache = SH.cache_specs(cfg, shape)
        cache = shard_tree(cache, SH.cache_shardings(cache, cfg, ctx), mesh)
        counter.track(cache)
    t0 = time.time()
    with counter:
        if shape.kind == "train":
            make_train_step(cfg, federated=federated, ctx=ctx)(params, batch)
        elif shape.kind == "prefill":
            make_prefill_step(cfg, shape.seq_len + CACHE_PAD,
                              ctx=ctx)(params, batch)
        else:
            make_serve_step(cfg, ctx=ctx)(params, cache, batch)
    return ctx, counter, time.time() - t0


def dry_run(arch: str, shape_name: str, multi_pod: bool,
            opt: bool = False) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    ctx, c, trace_s = trace_step(
        cfg, shape, mesh, federated=multi_pod and shape.kind == "train",
        opt=opt)
    coll = c.collective_bytes()
    coll_bytes = sum(v for k, v in coll.items() if k != "counts")
    roof = roofline_terms(flops_per_device=float(c.flops),
                          bytes_per_device=float(c.bytes),
                          collective_bytes_per_device=coll_bytes,
                          chips=chips,
                          model_flops=model_flops(cfg, shape, shape.kind))
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "kind": shape.kind,
        "tp_mode": ctx.tp,
        "opt": opt,
        "trace_s": trace_s,
        "memory_analysis": {"peak_bytes_per_device": c.peak},
        "cost_analysis": {"flops": float(c.flops), "bytes": float(c.bytes),
                          "collective_bytes": coll_bytes},
        "collectives": coll,
        "roofline": roof.to_dict(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="the reference's optimized (hybrid) sharding")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    jobs = []
    if args.all:
        for arch in list_archs():
            for shape in applicable_shapes(get_config(arch)):
                for mp in (False, True):
                    jobs.append((arch, shape.name, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        jobs.append((args.arch, args.shape, args.multi_pod))

    failures = 0
    for arch, shape_name, mp in jobs:
        tag = f"{arch}_{shape_name}_{'2x16x16' if mp else '16x16'}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {tag}", flush=True)
            continue
        try:
            res = dry_run(arch, shape_name, mp, opt=args.opt)
            with open(path, "w") as f:
                json.dump(res, f, indent=2)
            r = res["roofline"]
            print(f"[ok]  {tag}: trace={res['trace_s']:.1f}s "
                  f"bottleneck={r['bottleneck']} "
                  f"compute={r['compute_s']:.3e}s "
                  f"memory={r['memory_s']:.3e}s "
                  f"collective={r['collective_s']:.3e}s "
                  f"flops/dev={r['flops_per_device']:.4e} "
                  f"bytes/dev={r['bytes_per_device']:.4e} "
                  f"coll/dev={r['collective_bytes_per_device']:.4e} "
                  f"flops_ratio={r['flops_ratio']:.4f} peak="
                  f"{res['memory_analysis']['peak_bytes_per_device'] / 2**30:.2f}"
                  "GiB", flush=True)
        except Exception as e:   # one failed job must not hide the others
            failures += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run failures")
    print("dry-run complete")


if __name__ == "__main__":
    main()
