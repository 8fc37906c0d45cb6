"""The MoE over held experts, device ms a step: the ``lm.moe`` spans
(each MoE layer's FFN, forward and remat recompute) plus ``lm.moe_bwd``
(its backward, from the gradient hook on the FFN's output to the one on
its input) less the ``lm.mla`` and ``lm.moe`` spans inside it (the
layer's recompute runs there; those count once, under their own names),
mean over the traced steps."""
from portbench.harness import BENCH, load_module

_head = load_module(BENCH / "layer_metrics" / "lm.head_ms.py")


def read(run):
    whole = _head.step_device_ms(run, ("lm.moe", "lm.moe_bwd"))
    if whole is None:
        return None
    from repro_torch.obs import DEFAULT
    spans = DEFAULT.tracer.spans()
    roots = [i for i, s in enumerate(spans)
             if s.name == "lm.step" and s.parent is None][
        -int(run.driver.trace_steps):]

    def root(i):
        while spans[i].parent is not None:
            i = spans[i].parent
        return i

    nested = sum(s.device_s for s in spans
                 if s.name in ("lm.mla", "lm.moe") and s.parent is not None
                 and spans[s.parent].name == "lm.moe_bwd"
                 and root(s.parent) in roots)
    return whole - 1e3 * nested / len(roots)
