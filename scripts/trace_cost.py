#!/usr/bin/env python3
"""What the port's tracing costs when on, and what its spans cover of a
device trace, for one cell of the benchmark (``portbench/``).

    python3 scripts/trace_cost.py --workload resnet18gn-fscd --seed 7 \\
        [--seconds 10] [--pairs 2] [--out chiprun_out/trace_cost.json]

One process builds the cell as a ``--trace 1`` run does (its spans on)
and times windows of its steps with tracing off and on, in turns (off,
on, on, off, ...): for the FL cells the trainer's ``obs`` facade is
swapped for the shared no-op ``DISABLED`` and back, for the LM cell the
process-wide ``DEFAULT`` facade is armed, so that each step records its
spans and their CUDA events.  It then profiles the cell's traced steps
as a ``--trace 1`` run does (``layer_data``) and reports:

  FL  the traced window's device idle share split by the span open
      (prep, core, schedule, upload, finalize's own, eval, the round's
      own, no round) beside their sum and ``device_idle_pct.fl``, and
      the share of the device's busy time inside ``round`` spans;
  LM  each ``lm.*`` span's device ms a traced step, and the ``lm.step``
      spans' device time over the traced busy time;
  all the widest gap between a span's ends and its own ``obs:`` range in
      one more profiled step (the spans' clock against the profiler's),
      and the per-layer metrics the run's readers give.

Needs a CUDA device.  Prints one JSON object, also written to ``--out``.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FL_PHASES = ("prep", "core", "schedule", "upload")


def set_fl_obs(engine, obs):
    """Point an FL engine (and, in a multi-cell engine, its cells'
    evaluation and fault counters) at ``obs``."""
    engine.obs = obs
    for t in getattr(engine, "cells", [engine]):
        t._eval_obs = obs
        t.faults.obs = obs


def windows(driver, fl, seconds, pairs):
    """Alternating windows off/on: [(tracing, per-window metric)] (FL: ms a
    round; LM: tokens a second)."""
    from portbench import harness
    from repro_torch.obs import DEFAULT, DISABLED
    traced_obs = driver.engine.obs if fl else None
    out = []
    for on in [False, True, True, False] * pairs:
        if fl:
            set_fl_obs(driver.engine, traced_obs if on else DISABLED)
        else:
            DEFAULT.enabled = on
        steps, window_s = harness.measure(driver.step, seconds,
                                          getattr(driver, "finish", None))
        work = sum(w for _, _, w in steps)
        out.append((on, 1e3 * window_s / work if fl else work / window_s))
    if fl:
        set_fl_obs(driver.engine, traced_obs)
    else:
        DEFAULT.enabled = False
        DEFAULT.tracer.drain()
    return out


def fl_cover(run, idle_mod):
    """Idle share by span and busy share inside rounds, in % of the
    traced window (busy share: of the busy time)."""
    rec = run.layer["trace"]
    spans = idle_mod.traced_spans(run)
    idle = idle_mod.idle_intervals(rec)

    def under(*names):
        return 100.0 * idle_mod._overlap(idle, idle_mod._union(
            [(s, e) for n, s, e in spans if n in names])) / rec.window_s

    out = {name: under(name) for name in FL_PHASES}
    out["eval"] = under("eval")
    out["finalize_own"] = under("finalize") - out["eval"]
    in_round = under("round")
    out["round_own"] = in_round - sum(under(n) for n in FL_PHASES
                                      + ("finalize",))
    idle_pct = 100.0 * sum(e - s for s, e in idle) / rec.window_s
    out["unspanned"] = idle_pct - in_round
    rounds = idle_mod._union([(s, e) for n, s, e in spans if n == "round"])
    return {"idle_by_span_pct": out,
            "idle_sum_pct": sum(out.values()),
            "device_idle_pct": 100.0 * (1 - rec.busy_s / rec.window_s),
            "busy_in_rounds_pct": 100.0 * idle_mod._overlap(
                [list(iv) for iv in rec.busy_intervals], rounds)
            / rec.busy_s,
            "traced_rounds": sum(1 for n, _, _ in spans if n == "round")}


def lm_cover(run):
    from repro_torch.obs import DEFAULT
    spans = DEFAULT.tracer.spans()
    n = run.driver.trace_steps
    roots = [i for i, s in enumerate(spans)
             if s.name == "lm.step" and s.parent is None][-n:]

    def root(i):
        while spans[i].parent is not None:
            i = spans[i].parent
        return i

    per = {}
    for i, s in enumerate(spans):
        if root(i) in roots:
            per[s.name] = per.get(s.name, 0.0) + 1e3 * s.device_s / n
    step_s = sum(spans[i].device_s for i in roots)
    rec = run.layer["trace"]
    return {"device_ms_a_step": per,
            "step_spans_over_busy_pct": 100.0 * step_s / rec.busy_s,
            "device_idle_pct": 100.0 * (1 - rec.busy_s / rec.window_s)}


def clock_gap(driver, fl):
    """Widest |span end - its obs: range's end| in one profiled step, us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import DEFAULT
    if not fl:
        DEFAULT.tracer.drain()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        driver.step()
        torch.cuda.synchronize()
    if fl:
        rec = [r for r in driver.engine.obs.records() if "spans" in r][-1]
        spans = [(n, t0, t1) for n, _, t0, t1, _ in rec["spans"]]
    else:
        spans = [(s.name, s.t0_ns, s.t1_ns) for s in DEFAULT.tracer.spans()]
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("obs:") and \
                not str(ev.device_type()).endswith("CUDA"):
            ranges.setdefault(ev.name()[4:], []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    gaps = []
    for name, t0, t1 in spans:
        if ranges.get(name):
            r0, r1 = min(ranges[name], key=lambda r: abs(r[0] - t0))
            gaps.append(max(abs(r0 - t0), abs(r1 - t1)))
    return {"spans_matched": len(gaps),
            "widest_us": max(gaps) / 1e3 if gaps else None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_cost: needs a CUDA device")
    from portbench import harness
    cell = harness.Cell(args.workload)
    driver = cell.driver(seed=args.seed, device=torch.device("cuda"),
                         traced=True)
    t0 = time.perf_counter()
    driver.setup()
    fl = hasattr(driver, "engine")
    result = {"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(0),
              "setup_s": time.perf_counter() - t0}
    w = windows(driver, fl, args.seconds, args.pairs)
    off = [v for on, v in w if not on]
    on = [v for on, v in w if on]
    result["windows"] = [{"tracing": o, "value": v} for o, v in w]
    result["unit"] = "ms a round" if fl else "tokens/s"
    result["off_median"], result["on_median"] = (statistics.median(off),
                                                 statistics.median(on))
    result["on_cost_pct"] = 100.0 * (
        (result["on_median"] / result["off_median"] - 1) if fl
        else (1 - result["on_median"] / result["off_median"]))

    steps, window_s = harness.measure(driver.step, 2.0,
                                      getattr(driver, "finish", None))
    layer = driver.layer_data(steps)
    run = harness.Run(0.0, steps, window_s, driver, layer)
    if fl:
        idle_mod = harness.load_module(harness.BENCH / "layer_metrics"
                                       / "fl.idle_prep_pct.py")
        result["cover"] = fl_cover(run, idle_mod)
    else:
        result["cover"] = lm_cover(run)
    # (the round FLOPs an mfu reads start at set-up, not at this window)
    result["metrics"] = {k: v["value"] for k, v in harness.read_metrics(
        "layer_metrics", cell.per_layer, run).items()
        if not k.endswith("_mfu")}
    result["clock"] = clock_gap(driver, fl)
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
