"""The LM step's update, device ms a step of ``lm.update`` (the
gradients gathered, their norm, SGD in each leaf's dtype), mean over
the traced steps, as ``lm.head_ms`` reads its spans."""
from portbench.harness import BENCH, load_module

_head = load_module(BENCH / "layer_metrics" / "lm.head_ms.py")


def read(run):
    return _head.step_device_ms(run, ("lm.update",))
