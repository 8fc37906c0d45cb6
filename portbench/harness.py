"""The benchmark's shared machinery: a cell's spec, the files found by
name, the measured window and the guards on the result.

Everything that belongs to one configuration, traffic mix, driver or
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  configs/<file named in BENCHMARK.json>   sizes and dtypes
  workloads/<cell>.json                    driver kind, traffic parameters
  drivers/<kind>.py                        ``Driver`` (set-up, step, check)
  end_to_end/<metric>.py                   ``read(run)`` for a --trace 0 run
  layer_metrics/<metric>.py                ``read(run)`` for a --trace 1 run

A reader returns a number, or None where its run holds nothing to read;
the harness then leaves the metric out of the line.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# whole top-level module names that no run may load: JAX and the JAX
# package the port was made from (the port's own name starts with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module in the file ``path``, loaded under a private name (file
    names may hold dots, as metric names do)."""
    name = "portbench_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (``tag``) of a run's ``--seed``: the
    same seed gives the same streams, and streams never share draws."""
    h = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files: the
    workload's parameters, its configuration, and the metrics it reports
    (an end-to-end metric with a ``workloads`` list only in the cells it
    names; a per-layer metric likewise, or else wherever its ``moves``
    metric is reported)."""

    def __init__(self, name: str, bench_file: Path = ROOT / "BENCHMARK.json"):
        bench = load_json(bench_file)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.workload = load_json(BENCH / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if self.workload[key] != self.entry[key]:
                raise SystemExit(f"workloads/{name}.json names {key} "
                                 f"{self.workload[key]!r}, BENCHMARK.json "
                                 f"{self.entry[key]!r}")
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT / configs[self.entry["config"]]["file"])

        def here(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    def driver(self, **kw):
        mod = load_module(BENCH / "drivers" / f"{self.workload['driver']}.py")
        return mod.Driver(self, **kw)


def read_metrics(kind: str, metrics, run) -> dict:
    """``{name: {"value", "unit"}}`` for each metric whose reader (in
    ``kind``/) finds something to read."""
    out = {}
    for m in metrics:
        value = load_module(BENCH / kind / f"{m['name']}.py").read(run)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class Run:
    """What one run measured, for the metric readers.

    setup_s: process start to the first timed step; steps: (start, end,
    work) of each step of the window, on the host clock after the step's
    device work ended; window_s: the window's start to the end of its
    last step; layer: what a --trace 1 run gathered (the driver's spans
    and counters of the window, and ``trace``, the profiled steps'
    device record) ; driver: the cell's driver (its counts)."""

    def __init__(self, setup_s, steps, window_s, driver, layer=None):
        self.setup_s = setup_s
        self.steps = steps
        self.window_s = window_s
        self.driver = driver
        self.layer = layer or {}


def measure(step, seconds: float, finish=None):
    """Steps one after another until ``seconds`` have passed; the window
    ends when its last step ends.  ``step()`` returns the step's work
    (rounds or tokens), as a rule once its device work has ended; a
    driver whose steps return earlier gives ``finish``, which waits for
    the device, and the window ends when it returns."""
    steps = []
    t0 = time.perf_counter()
    t = t0
    while t - t0 < seconds:
        s = time.perf_counter()
        work = step()
        t = time.perf_counter()
        steps.append((s, t, work))
    if finish is not None:
        finish()
        t = time.perf_counter()
    return steps, t - t0


def format_checks(checks) -> dict:
    """``[(name, value, limit)]`` as the result line's ``checks`` key."""
    return {name: {"value": float(v), "limit": float(lim)}
            for name, v, lim in checks}


def checks_pass(checks) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)
