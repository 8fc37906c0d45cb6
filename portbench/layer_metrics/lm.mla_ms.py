"""Latent attention, device ms a step: the ``lm.mla`` spans (each layer's
attention, in the forward and in its remat recompute) plus ``lm.mla_bwd``
(its backward, between the gradient hooks on the attention's output and
on the layer's input), mean over the traced steps, as ``lm.head_ms``
reads its spans."""
from portbench.harness import BENCH, load_module

_head = load_module(BENCH / "layer_metrics" / "lm.head_ms.py")


def read(run):
    return _head.step_device_ms(run, ("lm.mla", "lm.mla_bwd"))
