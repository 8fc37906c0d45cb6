"""6 N D over the window: N the configuration's parameters (frozen
count), D the window's tokens, over the window's time at the H100's bf16
peak."""
from portbench.counts import rwkv6
from portbench.counts.peaks import BF16_FLOPS


def read(run):
    tokens = sum(work for _, _, work in run.steps)
    n = rwkv6.count_params(run.driver.model_p)
    return 100.0 * 6.0 * n * tokens / (run.window_s * BF16_FLOPS)
