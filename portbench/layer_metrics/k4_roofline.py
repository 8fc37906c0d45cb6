"""Kernel K4 at a (q/k, v) head pair (launch counter ``attention``, the
launches whose shapes carry v's): the least time of those launches in the
traced steps (frozen counts at the H100's peaks, ``counts/mla.py``) over
the device time of its kernel (flash_wgmma) there."""
from portbench.counts import mla


def read(run):
    rec = run.layer.get("trace")
    if rec is None:
        return None
    t = rec.kernel_seconds("flash_wgmma")
    bound = mla.bound_seconds(mla.k4, rec.shapes.get("attention", {}))
    if not t or not bound:
        return None
    return 100.0 * bound / t
