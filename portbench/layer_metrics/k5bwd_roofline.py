"""Kernel K5-bwd (launch counter ``wkv_bwd``): the least time of its
launches in the traced rounds (frozen counts at the H100's peaks) over
the device time of its kernels (wkv_bwd_chunked and wkv_bwd_du) there."""
from portbench.counts import kernels


def read(run):
    rec = run.layer.get("trace")
    if rec is None:
        return None
    t = sum(rec.kernel_seconds(k) for k in ("wkv_bwd_chunked", "wkv_bwd_du"))
    shapes = rec.shapes.get("wkv_bwd")
    if not t or not shapes:
        return None
    return 100.0 * kernels.bound_seconds(kernels.k5_bwd, shapes) / t
