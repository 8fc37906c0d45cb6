#!/usr/bin/env python3
"""The round core's local update two ways, on one NVIDIA GPU, at full
width on both of the paper's vision models.

    python3 scripts/local_update_paths.py [--calls N] [--rounds N]

The two ways:

  vmap  the port's ``repro_torch.fl.client.make_local_update``:
        ``torch.func.vmap`` over the devices, one forward and one
        backward for all devices, in which every weight gradient is a
        grouped convolution (one group a device, each device has its own
        weight gradient);
  loop  ``loop_update`` here, put in place of ``make_local_update``
        while its trainers are built: a Python loop over the devices, a
        plain forward and backward of each device's batch, one after
        another.

For each world of ``chip_smoke.py`` (``fl_world``: the paper CNN on 10
classes; ``resnet_world``: ResNet18-GN on 100 classes), with
``chip_smoke.fl_config("fedcgd-fscd")`` (V=64, availability 0.3, batch
32, tau 1, the torch scheduler, seed 0), the two ways take turns (vmap,
loop, loop, vmap), and each turn builds a fresh trainer and measures:

  core_ms    the round core (local update, Eq. 10 sigmas, deltas, norms,
             flags) on round 0's inputs, ``--calls`` calls (default 5)
             after one warm-up, host clock after ``synchronize``: median;
  device     one more core call under ``torch.profiler``: the device's
             summed kernel time, its op count and its three longest ops;
  round_ms   ``--rounds`` rounds (default 5) of a second fresh trainer,
             the ``obs`` span ``round``: the warm rounds (all but the
             first) and their median.

Each turn's core outputs on round 0's inputs are held to the first
turn's: bitwise within one way, and within 1e-4 relative between the
two ways (another order of float sums).  Prints the card's name and
power limit, then one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def loop_update(loss_fn, eta, tau):
    """``make_local_update`` by a loop over the devices: the same tau
    SGD steps a device, one device after another."""
    import torch
    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def one_device(params, dev_batches, dev_dropout):
        p, losses = params, []
        for t in range(tau):
            batch = {k: x[t] for k, x in dev_batches.items()}
            drop = tuple(m[t] for m in dev_dropout) or None
            grads, (loss, _) = grad_fn(p, batch, drop)
            p = {k: p[k] - eta * grads[k].to(p[k].dtype) for k in p}
            losses.append(loss)
        return p, torch.stack(losses).mean()

    def update(params, batches, dropout=()):
        V = next(iter(batches.values())).shape[0]
        outs = [one_device(params, {k: x[v] for k, x in batches.items()},
                           tuple(m[v] for m in dropout)) for v in range(V)]
        return ({k: torch.stack([o[0][k] for o in outs]) for k in params},
                torch.stack([o[1] for o in outs]))
    return update


def trainer(world, way):
    import chip_smoke as cs
    from repro_torch.fl import FederatedTrainer
    from repro_torch.fl import client
    kept = client.make_local_update
    if way == "loop":
        client.make_local_update = loop_update
    try:
        return FederatedTrainer(*world, cs.fl_config("fedcgd-fscd",
                                                     ring_size=64))
    finally:
        client.make_local_update = kept


def core_outputs(torch, tr, prep):
    out = tr._round_core({k: x[None] for k, x in tr.params.items()},
                         {k: x[None] for k, x in prep.batches.items()},
                         tuple(m[None] for m in prep.dropout))
    torch.cuda.synchronize()
    return out


def flat(torch, out):
    """The core's outputs as one f64 vector (device params, losses,
    sigmas, deltas, norms, flags)."""
    parts = []
    for o in out:
        leaves = o.values() if isinstance(o, dict) else [o]
        parts += [x.double().reshape(-1) for x in leaves]
    return torch.cat(parts)


def measure(torch, world, way, calls, rounds, first):
    from torch.profiler import ProfilerActivity, profile
    tr = trainer(world, way)
    prep = tr._prepare_round(0)
    out = flat(torch, core_outputs(torch, tr, prep))
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        again = core_outputs(torch, tr, prep)
        ms.append((time.perf_counter() - t0) * 1e3)
    same = bool(torch.equal(flat(torch, again), out))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        core_outputs(torch, tr, prep)
    evs = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    if first.get(way) is None:
        first[way] = out
    ref = first["vmap"] if first.get("vmap") is not None else out
    rel = float(((out - ref).abs() / (ref.abs() + 1.0)).max())
    bitwise_first = bool(torch.equal(out, first[way]))
    del tr, prep, again
    rt = trainer(world, way)
    for j in range(rounds):
        rt.run_round(j)
    round_ms = [r["round_s"] * 1e3 for r in rt.obs.records()]
    del rt
    torch.cuda.empty_cache()
    return {
        "core_ms": ms, "core_median_ms": statistics.median(ms),
        "device_busy_ms": sum(e.self_device_time_total for e in evs) / 1e3,
        "device_ops": sum(e.count for e in evs),
        "longest": [f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in evs[:3]],
        "round_ms": round_ms,
        "warm_round_median_ms": statistics.median(round_ms[1:]),
        "repeat_bitwise": same, "first_turn_bitwise": bitwise_first,
        "max_rel_diff_vs_vmap": rel,
    }


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("local_update_paths: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    card = cs.smi()
    print(f"card: {card}", flush=True)
    result = {"card": card}
    for name, make in (("paper-cnn-cifar10", cs.fl_world),
                       ("resnet18-gn-cifar100", cs.resnet_world)):
        world = make()
        first, turns = {}, []
        for way in ("vmap", "loop", "loop", "vmap"):
            r = measure(torch, world, way, args.calls, args.rounds, first)
            turns.append({"way": way, **r})
            print(f"{name} {way}: core median {r['core_median_ms']:.2f} ms "
                  f"({[round(x, 2) for x in r['core_ms']]}), device busy "
                  f"{r['device_busy_ms']:.3f} ms, {r['device_ops']} ops; "
                  f"longest {r['longest']}; rounds "
                  f"{[round(x, 2) for x in r['round_ms']]} ms, warm median "
                  f"{r['warm_round_median_ms']:.2f}; repeat bitwise "
                  f"{r['repeat_bitwise']}, equal to its first turn "
                  f"{r['first_turn_bitwise']}, max rel diff vs vmap "
                  f"{r['max_rel_diff_vs_vmap']:.3g}", flush=True)
            if not (r["repeat_bitwise"] and r["first_turn_bitwise"]
                    and r["max_rel_diff_vs_vmap"] <= 1e-4):
                raise AssertionError(f"{name} {way}: outputs differ")
        result[name] = turns
        del world
    print(cs.smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
