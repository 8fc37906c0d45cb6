#!/usr/bin/env python3
"""Whether a seeded FL round on one NVIDIA GPU is bitwise reproducible,
what breaks it, and what the fix costs in round time.

    python3 scripts/round_determinism.py [--src CHECKOUT] [--label NAME]
                                         [--rounds N] [--evidence]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout),
so that two trees can be timed in one run on one card, in turns.  The
world and the config are ``chip_smoke.py``'s FL main path
(``chip_smoke.fl_world``, ``chip_smoke.fl_config``): the full-width paper
CNN, V=64 devices, batch 32, synthetic 32x32x3 images, the torch
scheduler, seed 0.  ``chip_smoke.py`` itself runs 3 rounds a scheduler;
this script runs more, for a median over warm rounds.

Always: one ``FederatedTrainer`` of each of ``fedcgd-fscd`` and
``fedcgd-gs`` runs ``--rounds`` rounds (default 7) with the tree's own
settings; prints each round's wall time (the ``obs`` span ``round``),
the median over the warm rounds (all but the first), and the cuDNN
settings the trainer left (``cudnn.deterministic``, ``benchmark``).

With ``--evidence`` (needs this tree's trainer), under cuDNN's default
(``deterministic`` off, as before the fix) and with ``deterministic`` on:

  core_distinct   the round core called 6 times on one round's inputs:
                  the number of distinct results of each output (device
                  params by leaf, losses, sigmas, delta norms);
  ops_distinct    single operations of the local update, each called 6
                  times on one input under ``torch.func.vmap`` over 19
                  devices, as the core runs them: the weight and input
                  gradients of each convolution layer at its round shape,
                  the max-pool gradient, the dense layers' gradients;
  trainers        two trainers on one seed, 3 rounds each: whether their
                  histories, iteration counts and params are bitwise
                  equal (the setting is forced after construction);
  kernels         the device kernels of one core call by name from a
                  ``torch.profiler`` trace, with those that appear under
                  one setting only;
  flagged         the operations that ``torch.use_deterministic_algorithms
                  (True, warn_only=True)`` reports for one core call.

Prints the card's name and power limit, then one JSON object as the last
line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCHEDULERS = ("fedcgd-fscd", "fedcgd-gs")
REPEATS = 6


def trainer(torch, w, scheduler):
    import chip_smoke as cs
    from repro_torch.fl import FederatedTrainer
    return FederatedTrainer(*w, cs.fl_config(scheduler, ring_size=64))


def round_times(torch, w, rounds):
    out = {}
    for name in SCHEDULERS:
        tr = trainer(torch, w, name)
        settings = {"deterministic": torch.backends.cudnn.deterministic,
                    "benchmark": torch.backends.cudnn.benchmark}
        for j in range(rounds):
            tr.run_round(j)
        ms = [r["round_s"] * 1e3 for r in tr.obs.records()]
        out[name] = {"round_ms": ms, "warm_median_ms": statistics.median(
            ms[1:]), "cudnn": settings}
        print(f"{name}: rounds {[round(x, 2) for x in ms]} ms, warm median "
              f"{out[name]['warm_median_ms']:.2f} ms, cudnn {settings}",
              flush=True)
    return out


def digest(x) -> str:
    return hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()


def set_deterministic(torch, on: bool):
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def core_call(torch, tr, prep):
    return tr._round_core({k: x[None] for k, x in tr.params.items()},
                          {k: x[None] for k, x in prep.batches.items()},
                          tuple(m[None] for m in prep.dropout))


def core_distinct(torch, tr, prep):
    seen = {}
    for _ in range(REPEATS):
        dev, losses, sigma, _, norms, _ = core_call(torch, tr, prep)
        outs = {**{f"dev_params.{k}": x for k, x in dev.items()},
                "losses": losses, "sigma": sigma, "delta_norms": norms}
        for k, x in outs.items():
            seen.setdefault(k, set()).add(digest(x))
    return {k: len(v) for k, v in seen.items()}


def ops_distinct(torch, tr, prep):
    """Each gradient of the local update alone, under vmap over 19
    devices at the round's shapes, REPEATS times on one input."""
    import torch.nn.functional as F
    from repro_torch.models import cnn as C
    p = tr.params
    V, b = 19, 32
    gen = torch.Generator(device=tr.device).manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=tr.device)
    c32, c64 = C.channel_widths(tr.model.cfg)
    convs = {"c1": (3, 32), "c2": (c32, 32), "c3": (c32, 16),
             "c4": (c64, 16)}
    cases = {}
    for name, (cin, size) in convs.items():
        wv = p[name][None].repeat(V, 1, 1, 1, 1) + 0.01 * rand(
            V, *p[name].shape)
        x = rand(V, b, cin, size, size)
        up = rand(V, b, wv.shape[1], size, size)

        def loss(w_, x_, up_):
            return (F.conv2d(x_, w_, padding=1) * up_).sum()
        cases[f"{name} weight grad"] = (
            torch.func.vmap(torch.func.grad(loss, argnums=0)), (wv, x, up))
        cases[f"{name} input grad"] = (
            torch.func.vmap(torch.func.grad(loss, argnums=1)), (wv, x, up))
    xp = rand(V, b, c32, 32, 32)
    upp = rand(V, b, c32, 16, 16)
    cases["max_pool2d grad"] = (torch.func.vmap(torch.func.grad(
        lambda x_, up_: (F.max_pool2d(x_, 2) * up_).sum())), (xp, upp))
    wf = p["fc1"][None].repeat(V, 1, 1)
    xf = rand(V, b, wf.shape[1])
    upf = rand(V, b, wf.shape[2])
    cases["fc1 weight grad"] = (torch.func.vmap(torch.func.grad(
        lambda w_, x_, up_: ((x_ @ w_) * up_).sum())), (wf, xf, upf))
    out = {}
    for name, (fn, args) in cases.items():
        out[name] = len({digest(fn(*args)) for _ in range(REPEATS)})
    return out


def trainers_equal(torch, w, on: bool):
    runs = []
    for _ in range(2):
        tr = trainer(torch, w, "fedcgd-fscd")
        set_deterministic(torch, on)
        hist = tr.run(3)
        runs.append((hist, [r["sched_iterations"] for r in tr.obs.records()],
                     tr.params))
    (h1, i1, p1), (h2, i2, p2) = runs
    return {"history_equal": h1 == h2, "iterations": [i1, i2],
            "params_equal": all(torch.equal(p1[k], p2[k]) for k in p1)}


def kernel_names(torch, tr, prep):
    from torch.profiler import ProfilerActivity, profile
    core_call(torch, tr, prep)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        core_call(torch, tr, prep)
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}


def flagged_ops(torch, tr, prep):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            core_call(torch, tr, prep)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(c.message).split("\n")[0][:200] for c in caught})


def evidence(torch, w):
    tr = trainer(torch, w, "fedcgd-fscd")
    prep = tr._prepare_round(0)
    out = {}
    names = {}
    for on in (False, True):
        set_deterministic(torch, on)
        key = "deterministic" if on else "default"
        core_call(torch, tr, prep)          # warm-up: algorithm choice
        res = {"core_distinct": core_distinct(torch, tr, prep),
               "ops_distinct": ops_distinct(torch, tr, prep),
               "trainers": trainers_equal(torch, w, on)}
        names[key] = kernel_names(torch, tr, prep)
        res["kernels"] = names[key]
        out[key] = res
        print(f"cudnn {key}: " + json.dumps(
            {k: v for k, v in res.items() if k != "kernels"}), flush=True)
    only = {k: sorted(set(names[k]) - set(names[o]))
            for k, o in (("default", "deterministic"),
                         ("deterministic", "default"))}
    out["kernels_only_under"] = only
    print(f"kernels only under one setting: {json.dumps(only)}", flush=True)
    set_deterministic(torch, False)
    out["flagged"] = flagged_ops(torch, tr, prep)
    print(f"use_deterministic_algorithms flags: {out['flagged']}",
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--evidence", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                 # puts ROOT/src on the path
    import torch
    if not torch.cuda.is_available():
        print("round_determinism: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve() / "src"
    sys.path.insert(0, str(src))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    w = cs.fl_world()
    t0 = time.perf_counter()
    res = {"label": args.label, "src": args.src,
           "rounds": round_times(torch, w, args.rounds)}
    if args.evidence:
        res["evidence"] = evidence(torch, w)
    res["seconds"] = time.perf_counter() - t0
    print(cs.smi())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
