"""The device's idle time under no ``round`` span, in % of the traced
window: the driver's and the harness's time between rounds, which the
program cannot see.  The interval arithmetic is ``fl.idle_prep_pct``'s."""
from portbench.harness import BENCH, load_module

_idle = load_module(BENCH / "layer_metrics" / "fl.idle_prep_pct.py")


def read(run):
    spans = _idle.traced_spans(run)
    if spans is None:
        return None
    rec = run.layer["trace"]
    idle = _idle.idle_intervals(rec)
    rounds = _idle._union([(s, e) for n, s, e in spans if n == "round"])
    idle_s = sum(e - s for s, e in idle)
    return 100.0 * (idle_s - _idle._overlap(idle, rounds)) / rec.window_s
