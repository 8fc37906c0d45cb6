"""The device's idle share of the traced window: one minus the union of
its kernels', copies' and sets' intervals over the window's length."""


def read(run):
    rec = run.layer.get("trace")
    if rec is None or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
