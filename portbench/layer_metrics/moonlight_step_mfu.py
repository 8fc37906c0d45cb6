"""3 x the forward FLOPs a token of moonlight-16b-a3b's shapes (frozen
count, ``counts/mla.py``: the held routed experts at their expected share,
causal pairs exactly) x the window's tokens, over the window's time at the
H100's bf16 peak."""
from portbench.counts import mla
from portbench.counts.peaks import BF16_FLOPS


def read(run):
    tokens = sum(work for _, _, work in run.steps)
    f = mla.forward_flops_per_token(run.driver.model_p,
                                    run.driver.traffic["seq"])
    return 100.0 * 3.0 * f * tokens / (run.window_s * BF16_FLOPS)
