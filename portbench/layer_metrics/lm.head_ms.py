"""The LM step's head, device ms a step: ``lm.head`` (the f32 head and CE
forward) plus ``lm.head_bwd`` (their backward, up to the gradient hook
on the trunk's output), from the spans' CUDA events, mean over the
traced steps: the last ``trace_steps`` ``lm.step`` spans in the ring of
the process-wide ``repro_torch.obs.DEFAULT`` facade, which the step
traces while the profiler records.  The helper here serves
``lm.update_ms`` too."""


def step_device_ms(run, names):
    """Device ms a traced step of the spans ``names`` under ``lm.step``,
    or None where the run holds none (no trace, no device events)."""
    if run.layer.get("trace") is None:
        return None
    from repro_torch.obs import DEFAULT
    spans_of = getattr(DEFAULT.tracer, "spans", None)
    n = int(getattr(run.driver, "trace_steps", 0))
    if spans_of is None or n < 1:
        return None
    spans = spans_of()
    roots = [i for i, s in enumerate(spans)
             if s.name == "lm.step" and s.parent is None][-n:]
    if not roots:
        return None

    def root(i):
        while spans[i].parent is not None:
            i = spans[i].parent
        return i

    total = 0.0
    for i, s in enumerate(spans):
        if s.name in names and root(i) in roots:
            if s.device_s is None:
                return None
            total += s.device_s
    return 1e3 * total / len(roots)


def read(run):
    return step_device_ms(run, ("lm.head", "lm.head_bwd"))
