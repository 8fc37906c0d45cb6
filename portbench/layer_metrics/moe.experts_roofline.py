"""The held experts' grouped products: the least time of the traced
steps' products (frozen counts at the H100's peaks, ``counts/mla.py``,
with the steps' assignments from the program's counter
``moe_tokens_held``) over the device time of the kernels that compute
them (CUTLASS's grouped GEMM behind ``torch._grouped_mm``, whose names
hold ``GroupProblemShape``)."""
from portbench.counts import mla

KERNEL = "GroupProblemShape"


def read(run):
    rec = run.layer.get("trace")
    held = run.layer.get("moe_tokens_held")
    if rec is None or not held:
        return None
    t = sum(e - s for n, s, e in rec.ops if KERNEL in n)
    if not t:
        return None
    bound = sum(mla.experts(run.driver.model_p, a)[2] for a in held)
    return 100.0 * bound / t
