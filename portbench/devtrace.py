"""The device record of a --trace 1 run, reduced by the benchmark itself.

``capture`` runs a few of the cell's steps under ``torch.profiler`` and
keeps, inside the traced window (a ``record_function`` range around the
steps), every device interval: kernels, copies and sets.  Busy time is
the length of their union, so kernels that overlap count once (a sum of
kernel times can pass the window's length).  A trace can lose a batch of
device records while keeping the host's, so each trace is held to the
program's own launch counters: every launch of a named kernel in the
traced steps has to appear in it, or the trace is taken again, a bounded
number of times, and then the run fails rather than read a share from a
trace with holes.
"""
from __future__ import annotations

import collections
import re
import sys

WINDOW = "portbench.window"


class TraceIncomplete(RuntimeError):
    pass


def _span(ev):
    """(start, end) of a kineto event in seconds."""
    if hasattr(ev, "start_ns"):
        s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
    else:
        s, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
    return s, s + d


def _annotation(ev):
    """A ``record_function`` range (the profiler mirrors those on the
    device's timeline too; they are not device work)."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def _union(intervals):
    """Sorted, disjoint intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def kernel_pattern(name: str):
    """A regex that finds kernel ``name`` as a whole word in a demangled
    kernel name (``void wkv_chunked<64>(...)``)."""
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(name)
                      + r"(?![A-Za-z0-9_])")


class DeviceRecord:
    """One whole trace: ``window_s``, ``busy_s`` (the union of device
    intervals in the window), ``ops`` [(name, start, end)] on the device,
    the program's launches by shape in the traced steps (``shapes``), and
    the idle gaps named by what the host ran meanwhile."""

    def __init__(self, events, shapes):
        cpu, dev = [], []
        window = None
        for ev in events:
            s, e = _span(ev)
            if ev.name() == WINDOW:
                if not str(ev.device_type()).endswith("CUDA"):
                    window = (s, e)
            elif _annotation(ev):
                continue        # a host range mirrored on the device's line
            elif str(ev.device_type()).endswith("CUDA"):
                dev.append((ev.name(), s, e))
            else:
                cpu.append((ev.name(), s, e))
        if window is None:
            raise TraceIncomplete("the trace holds no window range")
        w0, w1 = window
        self.window_s = w1 - w0
        self.ops = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
                    if e > w0 and s < w1]
        self.busy_intervals = _union([(s, e) for _, s, e in self.ops])
        self.busy_s = sum(e - s for s, e in self.busy_intervals)
        self.shapes = shapes
        self._cpu = cpu
        self._window = window

    def kernel_seconds(self, name: str) -> float:
        pat = kernel_pattern(name)
        return sum(e - s for n, s, e in self.ops if pat.search(n))

    def kernel_count(self, name: str) -> int:
        pat = kernel_pattern(name)
        return sum(1 for n, _, _ in self.ops if pat.search(n))

    def top_ops(self, n=10):
        tot = collections.Counter()
        for name, s, e in self.ops:
            tot[name] += e - s
        return [[name[:160], sec] for name, sec in tot.most_common(n)]

    def idle_gaps(self, n=10):
        """The ``n`` longest gaps in device work inside the window, each
        named by the innermost host range running at its middle."""
        w0, w1 = self._window
        edges = [w0] + [x for iv in self.busy_intervals for x in iv] + [w1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            cover = [(ce - cs, name) for name, cs, ce in self._cpu
                     if cs <= mid <= ce]
            if cover:
                label = min(cover)[1]
            else:
                after = [(cs, name) for name, cs, _ in self._cpu if cs >= mid]
                label = ("python, then " + min(after)[1] if after
                         else "python")
            out.append([label[:160], length])
        return out


def capture(step, n_steps: int, kernels: dict, attempts: int = 4):
    """Profile ``n_steps`` calls of ``step`` and return a whole
    ``DeviceRecord``.  ``kernels`` maps a launch counter of the program
    (``repro_torch.kernels.common.LAUNCHES``) to the device kernels one
    such launch runs; the trace is whole when each kernel appears as
    often as its counter says."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import common
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in range(attempts):
        torch.cuda.synchronize()
        common.reset_launches()
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                for _ in range(n_steps):
                    step()
                torch.cuda.synchronize()
        launches = collections.Counter(common.LAUNCHES)
        shapes = {k: collections.Counter(v) for k, v in common.SHAPES.items()}
        rec = DeviceRecord(prof.profiler.kineto_results.events(), shapes)
        short = {}
        for counter, names in kernels.items():
            for kname in names:
                want, got = launches[counter], rec.kernel_count(kname)
                if got != want:
                    short[kname] = (got, want)
        if rec.busy_s > 0 and not short:
            return rec
        print(f"portbench: trace {attempt + 1} of {attempts} lost device "
              f"records (kernel: found, launched) {short}, busy "
              f"{rec.busy_s:.6f} s", file=sys.stderr)
    raise TraceIncomplete(f"{attempts} traces in a row lost device records")
