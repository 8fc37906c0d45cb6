"""Kernel K5 (launch counter ``wkv``): the least time of its
launches in the traced rounds (frozen counts at the H100's peaks) over
the device time of its kernels (wkv_chunked) there."""
from portbench.counts import kernels


def read(run):
    rec = run.layer.get("trace")
    if rec is None:
        return None
    t = rec.kernel_seconds("wkv_chunked")
    shapes = rec.shapes.get("wkv")
    if not t or not shapes:
        return None
    return 100.0 * kernels.bound_seconds(kernels.k5, shapes) / t
