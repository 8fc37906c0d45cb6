"""The device's idle time under the round's ``prep`` spans (the host's
availability, channel and batch draws and the batches' copies to the
device), in % of the traced window: the part of the window where the
device has no interval in the trace's ``busy_intervals`` while a
``prep`` span of a traced round is open.

The program's spans carry their ends on the profiler's clock (Unix-epoch
ns), so they lay over the device trace; a round is traced when its
``round`` span starts inside the final trace's window.  The helpers
here serve ``fl.idle_eval_pct`` and ``fl.idle_unspanned_pct`` too."""
from portbench.devtrace import _union


def _overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def traced_spans(run):
    """[(name, start_s, end_s)] of every span of the traced rounds, or
    None where the run holds no trace or its records no spans."""
    rec = run.layer.get("trace")
    engine = getattr(run.driver, "engine", None)
    if rec is None or engine is None or rec.window_s <= 0:
        return None
    w0, w1 = rec._window
    out = []
    for r in engine.obs.records():
        spans = r.get("spans") or ()
        roots = [s for s in spans if s[0] == "round" and s[1] is None]
        if roots and w0 <= roots[0][2] * 1e-9 <= w1:
            out += [(s[0], s[2] * 1e-9, s[3] * 1e-9) for s in spans]
    return out or None


def idle_intervals(rec):
    """The window's stretches with no device interval."""
    w0, w1 = rec._window
    edges = [w0] + [x for iv in rec.busy_intervals for x in iv] + [w1]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def idle_pct_under(run, name):
    """% of the traced window the device idles while a span ``name`` of
    a traced round is open (0 where the traced rounds hold none)."""
    spans = traced_spans(run)
    if spans is None:
        return None
    rec = run.layer["trace"]
    under = _union([(s, e) for n, s, e in spans if n == name])
    return 100.0 * _overlap(idle_intervals(rec), under) / rec.window_s


def read(run):
    return idle_pct_under(run, "prep")
