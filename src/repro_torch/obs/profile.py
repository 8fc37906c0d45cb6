"""``torch.profiler`` integration: capture a device trace of N rounds.

``profile_rounds(trainer, n, outdir)`` works for ``FederatedTrainer``,
``MultiCellTrainer`` and anything else with ``run_round(j)`` and a
``history`` list: it runs ``warmup`` rounds outside the trace, then
records ``n`` rounds under ``torch.profiler`` and writes the trace to
``outdir/trace.json`` (Chrome trace format: Perfetto or
``chrome://tracing`` open it).  The counterpart of
``repro/obs/profile.py``, whose ``jax.profiler`` trace TensorBoard reads.

What it returns is the trace directory, as a ``str``, carrying what the
trace shows (``Profile``): the wall time of the profiled rounds, the
device's busy time (the union of its kernels', copies' and sets'
intervals, so ops that overlap on other streams count once) and its
share of the wall time, the device-op count, the device time and count
of each kernel and, where live ``obs`` spans give the round's phases,
the same split per phase.  While the profiler records, every live span
opens a ``record_function`` range, ``obs:<name>`` (``obs.tracing``); the
profiler marks on the device's timeline the stretch from the first to
the last device op launched inside it, and a phase's device numbers are
the union of the ops run within its stretches and those of the spans
nested in it.  On a CPU trainer no device is traced: the device numbers
are None.  The profiler reads nothing back from the device besides its
own trace, so the rounds make the host pulls they make unprofiled
(tracing the host's ops as well as the device's slows the host, so the
wall time is longer than an unprofiled round's); with observability
disabled there are no spans and no phase split, and the trainer is left
untouched.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple, Union


def _union_us(ranges) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(ranges):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Profile(str):
    """The trace directory, with the trace's numbers as attributes:
    ``wall_ms``, ``device_ms``, ``device_ops``, ``busy_share`` (None
    without a traced device), ``kernels`` ({device op name: (ms, count)},
    longest first; empty without one) and ``phases`` ({phase: {"wall_ms",
    "device_ms", "device_ops", "busy_share"}} for each outermost span but
    ``round``, empty without spans; a phase's busy share is its device
    time over its host time)."""

    wall_ms: float
    device_ms: Optional[float]
    device_ops: Optional[int]
    busy_share: Optional[float]
    kernels: Dict[str, Tuple[float, int]]
    phases: Dict[str, Dict]


def profile_rounds(trainer, n: int, outdir: Union[str, os.PathLike],
                   warmup: int = 1) -> Profile:
    """Capture a ``torch.profiler`` trace of ``n`` steady-state rounds.

    Rounds continue from the trainer's current position
    (``len(trainer.history)``), so profiling composes with a run already
    in flight.  Returns the trace directory (a ``Profile``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    outdir = str(outdir)
    os.makedirs(outdir, exist_ok=True)
    j = len(trainer.history)
    for _ in range(warmup):
        trainer.run_round(j)
        j += 1
    device = torch.device(getattr(trainer, "device", "cpu"))
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.run_round(j)
            j += 1
        if cuda:
            torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))

    out = Profile(outdir)
    out.wall_ms = wall_us / 1e3
    out.device_ms = out.device_ops = out.busy_share = None
    out.kernels, out.phases = {}, {}
    events = prof.events()
    # the device's own events (kernels, copies, sets): not the CPU ops
    # that launched them, nor the device-side ranges of the spans, whose
    # device time is the same time again
    ops = [(e.time_range.start, e.time_range.end) for e in events
           if e.device_type != DeviceType.CPU and not e.is_user_annotation]
    if cuda:
        dev = sorted((e for e in prof.key_averages()
                      if e.device_type != DeviceType.CPU
                      and not e.is_user_annotation
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        out.kernels = {e.key: (e.self_device_time_total / 1e3, e.count)
                       for e in dev}
        busy = _union_us(ops)
        out.device_ms = busy / 1e3
        out.device_ops = len(ops)
        out.busy_share = busy / wall_us
    # the round's phases: the outermost spans other than "round" (prep,
    # core, ...); a nested span (solve_many.<backend>) counts for the
    # phase that holds it.  The profiler marks on the device's timeline
    # the stretch of each span's own device ops; a stretch belongs to the
    # latest span of its name that started before it.
    ranges = sorted(((e.name[4:], e.time_range.start, e.time_range.end,
                      e.cpu_time_total) for e in events
                     if e.name.startswith("obs:")
                     and e.device_type == DeviceType.CPU),
                    key=lambda s: s[1])

    def phase_of(name, lo, hi):
        return min((s for s in ranges if s[0] != "round"
                    and s[1] <= lo and hi <= s[2]),
                   key=lambda s: s[1], default=(name,))[0]

    for name, lo, hi, cpu_us in ranges:
        if name != "round" and phase_of(name, lo, hi) == name:
            ph = out.phases.setdefault(name, {
                "wall_ms": 0.0, "device_ms": None, "device_ops": None,
                "busy_share": None})
            ph["wall_ms"] += cpu_us / 1e3
    if cuda:
        stretches: Dict[str, list] = {}
        for e in events:
            if (e.name.startswith("obs:") and e.device_type != DeviceType.CPU
                    and e.name[4:] != "round"):
                lo = e.time_range.start
                owner = max((s for s in ranges if s[0] == e.name[4:]
                             and s[1] <= lo), key=lambda s: s[1],
                            default=None)
                if owner is not None:
                    stretches.setdefault(phase_of(*owner[:3]), []).append(
                        (lo, e.time_range.end))
        for name, ph in out.phases.items():
            # an op counts once, in however many of the phase's stretches
            inside = [(s, e) for s, e in ops
                      if any(lo <= s and e <= hi
                             for lo, hi in stretches.get(name, ()))]
            ph["device_ms"] = _union_us(inside) / 1e3
            ph["device_ops"] = len(inside)
    for ph in out.phases.values():
        if ph["device_ms"] is not None and ph["wall_ms"] > 0:
            ph["busy_share"] = ph["device_ms"] / ph["wall_ms"]
    return out
