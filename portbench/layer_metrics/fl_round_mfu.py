"""Model FLOPs of the window's rounds (ResNet18-GN forwards counted from
its layer shapes: 3 a local-update sample of an available device, 1 an
evaluated image) over the window's time at the H100's f32 peak."""
from portbench.counts.peaks import F32_FLOPS


def read(run):
    flops = run.layer.get("flops") or []
    if not flops:
        return None
    return 100.0 * sum(flops[:len(run.steps)]) / (run.window_s * F32_FLOPS)
