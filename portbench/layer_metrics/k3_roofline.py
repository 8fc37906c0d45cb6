"""K3 (the Eq. 10 kernel): the least time of its launches in the traced
rounds (frozen counts at the H100's peaks) over its device time there."""
from portbench.counts import kernels


def read(run):
    rec = run.layer.get("trace")
    if rec is None:
        return None
    t = rec.kernel_seconds("psg_kernel")
    shapes = rec.shapes.get("persample_gradnorm")
    if not t or not shapes:
        return None
    return 100.0 * kernels.bound_seconds(kernels.k3, shapes) / t
