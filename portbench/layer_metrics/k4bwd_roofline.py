"""Kernel K4-bwd at a (q/k, v) head pair (launch counter
``attention_bwd``): the least time of its launches in the traced steps
(frozen counts at the H100's peaks, ``counts/mla.py``) over the device
time of its kernels (attn_bwd_dq_wgmma and attn_bwd_dkv_wgmma) there."""
from portbench.counts import mla


def read(run):
    rec = run.layer.get("trace")
    if rec is None:
        return None
    t = sum(rec.kernel_seconds(k)
            for k in ("attn_bwd_dq_wgmma", "attn_bwd_dkv_wgmma"))
    bound = mla.bound_seconds(mla.k4_bwd, rec.shapes.get("attention_bwd",
                                                         {}))
    if not t or not bound:
        return None
    return 100.0 * bound / t
