"""The device's idle time under the traced rounds' ``eval`` spans
(evaluation: a batch's host-side copy, its forward, its pull), in % of
the traced window; 0 where no traced round evaluated.  The interval
arithmetic is ``fl.idle_prep_pct``'s."""
from portbench.harness import BENCH, load_module

_idle = load_module(BENCH / "layer_metrics" / "fl.idle_prep_pct.py")


def read(run):
    return _idle.idle_pct_under(run, "eval")
