#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

  1. builds the port's kernels from the sources in this checkout: the
     five CUDA C++ sources (``wemd``, ``persample_gradnorm``,
     ``flash_attention``, ``wkv``, ``rglru_scan``) with one nvcc each,
     all at once; prints ptxas's registers, spills and warnings for the
     kernels of ``wemd.cu``, ``flash_attention.cu`` and ``wkv.cu``;
  2. holds every kernel against its plain PyTorch version on the card,
     at ``tests/test_kernels.py``'s shape sweep and tolerances and at the
     round's shapes (``wemd_*`` to 1e-5 on f32 and on f64 inputs, the f64
     output bitwise equal to the output on the f32-cast inputs; sigma to
     1e-3, gi_sq to atol 1e-2; attention f32 atol 3e-5 / rtol 1e-4, bf16
     atol 1e-3 / rtol 8e-3, tighter than the sweep's 3e-2; wkv atol 2e-3
     / rtol 1e-3 on y and state, with T = 1, T = 17, T = 3072, hd 128
     and an empty batch, and 1e-3 in the w=1e-4 and w=1e-8 cases; rglru
     1e-5);
  3. solves 50 seeded random P1 problems with the torch scheduler on the
     card and requires the numpy solvers' masks and iteration counts;
  4. drives the FL main path: ``FederatedTrainer`` on the full-width
     paper CNN (V=64 devices, batch 32, 32x32x3 images, dropout on), 3
     rounds of ``fedcgd-fscd`` and 3 of ``fedcgd-gs`` with
     ``scheduler_backend="torch"``; every round must have finite losses,
     2 host syncs, the numpy solver's mask on the same Problem and
     Eq. 10 sigmas (from the ``persample_gradnorm`` kernel) within
     atol 1e-3 + rtol 1e-3 of the closed form on the same features, and
     every FL kernel must have been launched in that run; a second
     ``fedcgd-fscd`` trainer on the same seed must give a bitwise-equal
     history (records, masks, iteration counts, sigmas) and bitwise-equal
     params after its 3 rounds; then one more round of each, held to the
     same checks, under ``torch.profiler`` (the device's busy share of the
     round and its longest kernels);
  5. drives the LM serving path through ``repro_torch.serve.generate``:
     recurrentgemma-2b, then rwkv6-3b, each at published width and full
     depth in bf16 with seeded random weights, B=4 prompts of 3072
     tokens (longer than the 2048 window), 32 sampled tokens.  Prefill
     must launch the attention kernel 8 times and the RG-LRU kernel 18
     times (recurrentgemma), the WKV kernel 32 times (rwkv6), and decode
     no kernel; logits must be finite; and a prefill of P tokens plus 8
     teacher-forced ``serve_step``s (the plain decode route) must agree
     with one prefill of P+8 tokens (the kernel route), in f32 on each
     reduced config (2e-3 * scale, the bound of the JAX package's
     tests/test_models_smoke.py) and in bf16 on the full ones and on
     their first layers (``BF16_CONSISTENCY``, ``LM_DEPTHS``);
  6. times each kernel at the shapes of its last main-path launch (the
     LM kernels at their prefill shapes) beside its plain version, one
     library call where one computes the same function (``cdist`` for
     the WEMD scans, ``scaled_dot_product_attention`` under the window
     mask for attention), and the least time the card could take (its
     bound), and holds it to its plain version there again (attention
     also in f32 at that shape, atol 3e-5 / rtol 1e-4): ``ms`` is
     the median per-call time of back-to-back calls by CUDA events (what
     a caller pays, launch included), ``device_ms`` the kernels' own
     device time from a ``torch.profiler`` trace; for the WEMD kernels
     also ``path_ms``, the call as the scheduler makes it (``ops.wemd_*``
     on f64 inputs, bitwise equal to ``ms``'s call on the cast inputs);
     for attention also the rate over the visible pairs (``tflops``);
     for attention and wkv the share of the bound (``bound_share``, bound
     over device time).

Before the last line come a JSON object with one entry per kernel and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SIGMA_ATOL = SIGMA_RTOL = 1e-3  # the round's sigmas vs the closed form
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12         # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
TPU_KERNELS = {
    "wemd_add": "src/repro/kernels/wemd_swap.py:115",
    "wemd_swap": "src/repro/kernels/wemd_swap.py:74",
    "persample_gradnorm": "src/repro/kernels/persample_gradnorm.py:65",
    "attention": "src/repro/kernels/flash_attention.py:77",
    "wkv": "src/repro/kernels/rwkv_scan.py:75",
    "rglru": "src/repro/kernels/rglru_scan.py:50",
}
FL_KERNELS = ("wemd_add", "wemd_swap", "persample_gradnorm")
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "wemd_add": ("cuda", CSRC + "wemd.cu"),
    "wemd_swap": ("cuda", CSRC + "wemd.cu"),
    "persample_gradnorm": ("cuda", CSRC + "persample_gradnorm.cu"),
    "attention": ("cuda", CSRC + "flash_attention.cu"),
    "wkv": ("cuda", CSRC + "wkv.cu"),
    "rglru": ("cuda", CSRC + "rglru_scan.cu"),
}
# LM serving phase: batch, prompt (> the 2048 window), sampled tokens,
# teacher-forced decode steps of the consistency check
LM_BATCH, LM_PROMPT, LM_GEN, LM_CHECK = 4, 3072, 32, 8
LM_PREFILL_LAUNCHES = {"recurrentgemma-2b": {"attention": 8, "rglru": 18},
                       "rwkv6-3b": {"wkv": 32}}
# prefill (kernel route) vs decode (plain route) at bf16: max abs error
# over max(1, max |logit|), and relative L2 error.  bf16 keeps 8 bits;
# the decode route rounds attention probabilities to bf16 where the
# kernel keeps them in f32, and matmuls of other shapes round otherwise.
# The readings at full depth are deterministic (three runs on one H100
# gave the same digits): recurrentgemma-2b 0.006825 and 0.02242, rwkv6-3b
# 0.06971 and 0.06116, which is the size of the JAX package's own bf16
# error for rwkv6 (tests/test_torch_lm.py).  The bounds are about 1.5x
# recurrentgemma's readings and 1.3-1.4x rwkv6's.
BF16_CONSISTENCY = {"recurrentgemma-2b": (0.01, 0.035),
                    "rwkv6-3b": (0.1, 0.08)}
# depths (whole pattern periods) of the first layers whose bf16
# prefill/decode gap is also read, to see where over the depth it grows
LM_DEPTHS = {"recurrentgemma-2b": (3, 6, 12, 24),
             "rwkv6-3b": (1, 2, 4, 8, 16)}
F32_CONSISTENCY = 2e-3          # tests/test_models_smoke.py's bound
# bf16 attention against its f32-accumulated plain version: both round
# the same f32 value to bf16 once, so they differ by at most one bf16
# step (< 2**-7 relative) plus f32 noise
BF16_ATTN_TOL = (1e-3, 8e-3)
F32_ATTN_TOL = (3e-5, 1e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query="name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# kernel inputs, plain versions, library yardsticks and bounds


def wemd_inputs(torch, B, V, C, size, seed, device, dtype=None):
    """f32 inputs, or f64 as the scheduler keeps them."""
    import numpy as np
    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    p_dev = torch.tensor(rng.dirichlet(np.full(C, 0.4), size=(B, V)),
                         dtype=dtype, device=device)
    p_sum = p_dev[:, :size].sum(dim=1)
    gd = p_dev.mean(dim=1)
    cw = torch.tensor(rng.uniform(0.5, 1.5, (B, C)), dtype=dtype,
                      device=device)
    sizes = torch.full((B,), float(size), dtype=dtype, device=device)
    return p_sum, p_dev, gd, cw, sizes


def psg_inputs(torch, V, B, d, C, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = torch.randn((V, B, d), generator=g).to(device)
    logits = torch.randn((V, B, C), generator=g).to(device)
    labels = torch.randint(0, C, (V, B), generator=g).to(device)
    return h, logits, labels


def attn_inputs(torch, B, H, KV, S, T, hd, dtype, seed, device):
    """q [B,H,S,hd] and k, v [B,KV,T,hd] as views of [B,S,H,hd] memory,
    the layout the model hands the kernel."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(n, heads):
        return torch.randn((B, n, heads, hd), generator=g, device=device,
                           dtype=dtype).transpose(1, 2)
    return draw(S, H), draw(T, KV), draw(T, KV)


def wkv_inputs(torch, B, T, H, hd, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale
    w = torch.sigmoid(randn(B, T, H, hd) * 2) * 0.6 + 0.39
    return (randn(B, T, H, hd), randn(B, T, H, hd, scale=0.3),
            randn(B, T, H, hd), w, randn(H, hd, scale=0.1),
            randn(B, H, hd, hd, scale=0.5))


def rglru_inputs(torch, B, T, D, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((B, T, D), generator=g, device=device) * 0.199 + 0.8
    return (a, torch.randn((B, T, D), generator=g, device=device),
            torch.randn((B, D), generator=g, device=device))


def window_mask(torch, S, T, causal, window, device):
    """[S,T] bool, True where attention_ref lets query q see key k."""
    qi = torch.arange(S, device=device)[:, None] + (T - S)
    ki = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    return ok


def cdist_add(torch, p_sum, p_dev, gd, cw, sizes):
    """wemd_add as one L1 distance: cw >= 0 folds into both sides."""
    s1 = (sizes + 1.0)[:, None, None]
    x = p_dev / s1 * cw[:, None, :]
    y = -((p_sum[:, None, :] / s1 - gd[:, None, :]) * cw[:, None, :])
    return x, y


def cdist_swap(torch, p_sum, p_dev, gd, cw, sizes):
    s = sizes[:, None, None]
    a = ((p_sum[:, None, :] - p_dev) / s - gd[:, None, :]) * cw[:, None, :]
    b = -(p_dev / s) * cw[:, None, :]
    return a, b


def visible_pairs(S, T, causal, window):
    """(query, key) pairs attention_ref lets through, per (batch, head)."""
    import numpy as np
    q = np.arange(S) + (T - S)
    hi = np.minimum(q, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(S, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound(name, shapes, itemsize=4):
    """(bound_ms, bound_by): bytes each input read once and each output
    written once over HBM, operations over the peak rate of their type
    (the f32 rate, and bf16 tensor cores for bf16 attention)."""
    rate = F32_FLOPS_PER_S
    if name == "attention":
        (B, H, S, hd), (_, KV, T, _), (causal, window) = shapes
        nbytes = itemsize * (2 * B * H * S * hd + 2 * B * KV * T * hd)
        ops = 4 * hd * B * H * visible_pairs(S, T, causal, window)
        rate = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    elif name == "wkv":
        (B, T, H, hd), = shapes
        nbytes = 4 * (5 * B * T * H * hd + H * hd + 2 * B * H * hd * hd)
        ops = B * H * T * (5 * hd * hd + 3 * hd)
    elif name == "rglru":
        (B, T, D), = shapes
        nbytes = 4 * (3 * B * T * D + 2 * B * D)
        ops = 2 * B * T * D
    elif name == "wemd_add":
        (B, V, C), = shapes
        nbytes = 4 * (3 * B * C + B * V * C + B + B * V)
        ops = 6 * B * V * C
    elif name == "wemd_swap":
        (B, V, C), = shapes
        nbytes = 4 * (3 * B * C + B * V * C + B + B * V * V)
        ops = 7 * B * V * V * C
    else:
        (V, B, d), (_, _, C) = shapes
        nbytes = 4 * (V * B * d + V * B * C + V * B + V * B + V)
        ops = V * (8 * B * C + 2 * B * d + 2 * B * d * C + 2 * d * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def calls_per_rep(torch, fn, most=50, target_s=0.05):
    """Back-to-back calls that take about ``target_s`` (1 to ``most``),
    from one timed call after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(1, min(most, int(target_s / (time.perf_counter() - t0))))


def time_ms(torch, fn, reps=7):
    """Median over ``reps`` of the mean per-call time of back-to-back
    calls (50, or fewer for a slow call), by CUDA events, after a
    warm-up."""
    inner = calls_per_rep(torch, fn)
    reps = reps if inner > 1 else 3
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def profiler_works(torch) -> bool:
    """Whether ``torch.profiler`` can trace the card here, from one
    traced no-op.  Only this probe is guarded: the profiled work itself
    runs outside any ``try``, so its failures end the script."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"profiler unavailable, device times not measured: {e}")
        return False
    return True


def device_ms(torch, fn):
    """Device time of the kernels ``fn`` launches, per call, from a
    ``torch.profiler`` trace of 50 calls or fewer (None when the trace
    holds no device time): the kernels' own time, without the host's
    launch path.  A trace can drop a launch, so each kernel's mean
    time is weighted by its launches per call (its count over the calls,
    rounded), not summed and divided by the calls."""
    from torch.profiler import ProfilerActivity, profile
    n = calls_per_rep(torch, fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.count:
            total_us += t / ev.count * max(1, round(ev.count / n))
    return total_us / 1e3 if total_us > 0 else None


# ---------------------------------------------------------------------------
# phases


def phase_build(torch, dev):
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import common
    from repro_torch.kernels import flash_attention as K4
    from repro_torch.kernels import persample_gradnorm as K3
    from repro_torch.kernels import rglru_scan as K6
    from repro_torch.kernels import rwkv_scan as K5
    from repro_torch.kernels import wemd_swap as K12
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:     # one nvcc per source, at once
        for f in [pool.submit(fn) for fn in (K12._launchers, K3._launcher,
                                             K4._launcher, K5._launcher,
                                             K6._launcher)]:
            f.result()
    log(f"build: nvcc of 5 sources in parallel "
        f"{time.perf_counter() - t0:.2f} s (" + ", ".join(
            f"{k} {v:.2f} s" for k, v in common.BUILD_SECONDS.items()) + ")")
    log("ptxas, wemd.cu: " + ptxas_summary(
        common.BUILD_LOGS.get("wemd.cu", "")))
    lib = common.load_library("flash_attention.cu")
    log("ptxas, flash_attention.cu: " + ptxas_summary(
        common.BUILD_LOGS.get("flash_attention.cu", ""))
        + "; dynamic shared memory a block: " + ", ".join(
            f"{route} hd{hd} {lib.flash_attention_smem_bytes(hd, dt)} B"
            for dt, route in ((1, "bf16"), (0, "f32"))
            for hd in K4.HEAD_SIZES))
    log("ptxas, wkv.cu: "
        + ptxas_summary(common.BUILD_LOGS.get("wkv.cu", "")))


def ptxas_summary(text: str) -> str:
    """Registers, spills and static shared memory of each kernel in an
    ``nvcc -Xptxas -v`` log, and every ptxas warning (``wgmma``
    serialisation among them).  The attention kernels' shared memory is
    dynamic, so ptxas does not see it: ``flash_attention_smem_bytes``
    reports it."""
    import re
    out, name = [], "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_(wgmma|kernel)ILi(\d+)E", line)
            w = re.search(r"wemd_(add|swap)_kernelI([fd])E", line)
            c = re.search(r"wkv_chunkedILi(\d+)E", line)
            if m:
                name = (f"{'bf16 wgmma' if m[1] == 'wgmma' else 'f32'} "
                        f"hd{m[2]}")
            elif w:
                name = f"{w[1]} {'f64' if w[2] == 'd' else 'f32'} inputs"
            elif c:
                name = f"wkv hd{c[1]}"
            else:
                name = line.split("'")[1]
        elif "spill stores" in line:
            out.append(f"{name}: {line.strip()}")
        elif "Used" in line and "registers" in line and out:
            out[-1] += "; " + line.split(":", 1)[1].strip()
        elif "warning" in line:
            out.append(line.strip())
    return " | ".join(out) if out else "no report (library was cached)"


def phase_kernel_checks(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda, persample_gradnorm_cuda_batched)
    worst = {}

    def close(name, got, want, atol, rtol):
        torch.cuda.synchronize()
        err = (got - want).abs()
        require(bool((err <= atol + rtol * want.abs()).all()),
                f"{name}: max abs err {float(err.max()):.3g} over tolerance")
        worst[name] = max(worst.get(name, 0.0), float(err.max()))

    wemd_checks(torch, dev, close)
    for i, (B, d, C) in enumerate([(64, 120, 10), (100, 512, 100),
                                   (32, 48, 5), (130, 64, 16),
                                   (32, 120, 10)]):
        h, logits, labels = psg_inputs(torch, 1, B, d, C, 50 + i, dev)
        s, gi = persample_gradnorm_cuda(h[0], logits[0], labels[0])
        sr, gr = ref.persample_gradnorm_ref(h[0], logits[0], labels[0])
        close("persample_gradnorm", s, sr, 1e-3, 1e-3)
        close("persample_gradnorm.gi_sq", gi, gr, 1e-2, 1e-3)
    for i, V in enumerate((19, 64)):                 # the round's batched call
        h, logits, labels = psg_inputs(torch, V, 32, 120, 10, 70 + i, dev)
        s, gi = persample_gradnorm_cuda_batched(h, logits, labels)
        sr, gr = ref.persample_gradnorm_ref(h, logits, labels)
        close("persample_gradnorm", s, sr, 1e-3, 1e-3)
        close("persample_gradnorm.gi_sq", gi, gr, 1e-2, 1e-3)
    lm_kernel_checks(torch, dev, close)
    log("kernels vs plain: " + ", ".join(
        f"{k} max abs err {v:.3g}" for k, v in worst.items()))


def wemd_checks(torch, dev, close):
    """Both WEMD kernels against their plain versions to 1e-5 at the sweep
    and the round's shapes, on f32 inputs and on f64 inputs (the
    scheduler's); the f64 output must be bitwise the output on the
    f32-cast inputs.  (2, 300, 10) takes more than one block of devices."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wemd_swap import wemd_add_cuda, wemd_swap_cuda
    f64 = torch.float64
    swap_shapes = [(2, 16, 10), (1, 64, 10), (3, 7, 5), (2, 33, 100),
                   (1, 130, 130), (2, 19, 11), (32, 19, 10), (32, 64, 10),
                   (2, 300, 10)]
    add_shapes = [(2, 16, 10), (1, 64, 10), (3, 7, 5), (2, 33, 100),
                  (1, 19, 10), (1, 64, 10), (1, 130, 130), (2, 300, 10)]
    for name, kern, plain, shapes, size, seed in (
            ("wemd_swap", wemd_swap_cuda, ref.wemd_swap_ref, swap_shapes, 5,
             10),
            ("wemd_add", wemd_add_cuda, ref.wemd_add_ref, add_shapes, 3, 30)):
        for i, (B, V, C) in enumerate(shapes):
            args = wemd_inputs(torch, B, V, C, min(size, V), seed + i, dev)
            out, want = kern(*args), plain(*args)
            require(out.shape == want.shape, f"{name} shape")
            close(name, out, want, 1e-5, 1e-5)
            a64 = wemd_inputs(torch, B, V, C, min(size, V), seed + i, dev,
                              f64)
            a32 = [a.float() for a in a64]
            out64 = kern(*a64)
            close(f"{name}.f64", out64, plain(*a32), 1e-5, 1e-5)
            require(out64.dtype == torch.float32
                    and torch.equal(out64, kern(*a32)),
                    f"{name} at {(B, V, C)}: the f64 output is not the "
                    f"output on the f32-cast inputs")


def lm_kernel_checks(torch, dev, close):
    """The LM kernels against their plain versions at
    ``tests/test_kernels.py``'s sweep and tolerances, plus one case of
    recurrentgemma's layout (ten query heads on one key head, hd 256)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru_scan import rglru_cuda
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(B, H, H, S, T, hd, c, w, f32)
             for B, H, S, T, hd in [(2, 3, 128, 128, 64), (1, 2, 256, 256, 64),
                                    (2, 2, 100, 100, 32), (1, 2, 64, 192, 64),
                                    (1, 1, 128, 128, 128), (1, 1, 257, 257, 64)]
             for c, w in [(True, 0), (True, 32), (False, 0)]]
    cases += [(1, 2, 2, 128, 128, 64, True, 0, bf16),
              (2, 10, 1, 300, 300, 256, True, 64, f32),
              (2, 10, 1, 300, 300, 256, True, 64, bf16)]
    for i, (B, H, KV, S, T, hd, causal, window, dt) in enumerate(cases):
        q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, dt, 100 + i, dev)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        require(out.dtype == dt, "attention output dtype")
        if dt == f32:
            close("attention", out, want, *F32_ATTN_TOL)
        else:
            close("attention.bf16", out.float(), want.float(),
                  *BF16_ATTN_TOL)
    wkv_checks(torch, dev, close)
    for i, (B, T, D) in enumerate([(2, 300, 64), (1, 128, 512),
                                   (3, 37, 100), (1, 1024, 256)]):
        args = rglru_inputs(torch, B, T, D, 300 + i, dev)
        h, hT = rglru_cuda(*args)
        hr, hTr = ref.rglru_ref(*args)
        close("rglru", h, hr, 1e-5, 1e-5)
        close("rglru", hT, hTr, 1e-5, 1e-5)


def wkv_checks(torch, dev, close):
    """The WKV kernel against its step-by-step plain version at atol 2e-3
    / rtol 1e-3 on y and the final state: the sweep, T = 1 and T = 17 (a
    chunk mostly past T), T = 3072 (192 chunks of drift), hd 128; an empty batch
    launches nothing; w = 1e-4 (hd 16) and w = 1e-8 over 48 steps (hd 64)
    finite and within 1e-3."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    for i, (B, T, H, hd) in enumerate([(2, 48, 3, 32), (1, 16, 2, 64),
                                       (2, 100, 2, 16), (1, 64, 1, 64),
                                       (2, 1, 2, 64), (2, 17, 3, 64),
                                       (1, 3072, 2, 64), (2, 40, 2, 128)]):
        args = wkv_inputs(torch, B, T, H, hd, 200 + i, dev)
        y, st = wkv_cuda(*args)
        yr, sr = ref.wkv_ref(*args)
        close("wkv", y, yr, 2e-3, 1e-3)
        close("wkv.state", st, sr, 2e-3, 1e-3)
    args = wkv_inputs(torch, 0, 16, 2, 64, 208, dev)
    before = LAUNCHES["wkv"]
    y, st = wkv_cuda(*args)
    require(tuple(y.shape) == (0, 16, 2, 64) and tuple(st.shape)
            == (0, 2, 64, 64) and LAUNCHES["wkv"] == before,
            "wkv: an empty batch gives empty outputs and no launch")
    for i, (T, hd, wval) in enumerate([(32, 16, 1e-4), (48, 64, 1e-8)]):
        r, k, v, _, u, _ = wkv_inputs(torch, 1, T, 1, hd, 210 + i, dev)
        w = torch.full_like(r, wval)                # extreme decay
        s0 = torch.zeros((1, 1, hd, hd), device=dev)
        y, st = wkv_cuda(r, k, v, w, u, s0)
        require(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
                f"wkv: not finite at w={wval}")
        yr, sr = ref.wkv_ref(r, k, v, w, u, s0)
        close("wkv", y, yr, 1e-3, 1e-3)
        close("wkv.state", st, sr, 1e-3, 1e-3)


def phase_scheduler(torch, dev):
    import numpy as np
    from repro_torch.core import scheduling as S
    from repro_torch.obs import Obs

    def random_problem(rng, V, C, infeasible_frac):
        p_dev = rng.dirichlet(np.full(C, 0.4), size=V)
        min_bw = rng.uniform(0.4, 1.6, V)
        if infeasible_frac:
            min_bw[rng.random(V) < infeasible_frac] = -1.0
        return S.Problem(p_dev=p_dev,
                         global_dist=rng.dirichlet(np.full(C, 3.0)),
                         class_weights=rng.uniform(0.5, 1.5, C),
                         sigma=float(rng.uniform(2.0, 6.0)), batch_size=32,
                         min_bw=min_bw, total_bw=V * 0.5)

    obs = Obs(enabled=True)
    for V in (16, 64):
        rng = np.random.default_rng(2000 + V)
        probs = [random_problem(rng, V, 10, 0.2 if t % 3 == 0 else 0.0)
                 for t in range(25)]
        for alg, fn in (("gs", S.greedy_scheduling), ("fscd", S.fscd)):
            t0 = time.perf_counter()
            got = S.solve_many(probs, alg, backend="torch", obs=obs,
                               device=dev)
            dt = time.perf_counter() - t0
            for t, (p, g) in enumerate(zip(probs, got)):
                e = fn(p)
                require(np.array_equal(e.mask, g.mask)
                        and e.iterations == g.iterations,
                        f"scheduler {alg} V={V} problem {t}: mask or "
                        f"iterations differ from numpy")
            log(f"scheduler {alg} V={V}: 25 problems equal to numpy, "
                f"{dt:.3f} s")
    c = obs.metrics.counters
    log(f"scheduler host syncs: {int(c['sched.host_syncs.torch'].value)} "
        f"over {int(c['sched.solve_many_calls.torch'].value)} batched solves")


def check_round(torch, tr, solve, tag, rec) -> tuple:
    """Hold one main-path round to the numpy solver's mask and iteration
    count on the same Problem, finite losses, 2 host syncs, and its
    kernel-computed Eq. 10 sigmas to the closed form on the same
    features; returns the sigmas' (max abs error, max relative error,
    largest closed-form sigma)."""
    import numpy as np
    from repro_torch.core import estimation as E
    from repro_torch.fl.rounds import _cnn_features_logits
    prob, sched = tr.solved[-1]
    want = solve(prob)
    require(np.array_equal(want.mask, sched.mask)
            and want.iterations == sched.iterations,
            f"{tag}: mask differs from numpy")
    require(np.isfinite(rec["mean_local_loss"]), f"{tag}: loss not finite")
    require(tr.last_round_host_syncs == 2,
            f"{tag}: {tr.last_round_host_syncs} host syncs")
    params, images, labels, sigma = tr.sigmas[-1]
    V, b = labels.shape
    feats, logits = _cnn_features_logits(
        params, tr.model.cfg, images.reshape((V * b,) + images.shape[2:]))
    closed = E.sigma_hat_lastlayer(feats.reshape(V, b, -1),
                                   logits.reshape(V, b, -1), labels)
    err = (sigma - closed).abs()
    require(bool((err <= SIGMA_ATOL + SIGMA_RTOL * closed.abs()).all()),
            f"{tag}: sigma max abs err {float(err.max()):.3g} against the "
            f"closed form")
    return (float(err.max()), float((err / closed.abs()).max()),
            float(closed.abs().max()))


def fl_world():
    """The main path's world: the full-width paper CNN, synthetic 32x32x3
    images of 10 classes, sorted and split over 64 devices, seed 0:
    (model, train, test, parts)."""
    import numpy as np
    from repro_torch.configs.paper_cnn import PAPER_CNN_CIFAR10
    from repro_torch.data import (sort_and_partition, synthetic_image_dataset,
                                  train_test_split)
    from repro_torch.models.registry import build_model
    ds = synthetic_image_dataset(num_classes=10, num_per_class=500,
                                 image_size=32, channels=3, seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 64, 1,
                               np.random.default_rng(0))
    return build_model(PAPER_CNN_CIFAR10), train, test, parts


def fl_config(sched_name, ring_size=16):
    """The main path's ``FLConfig`` for one scheduler."""
    from repro_torch.fl import FLConfig
    from repro_torch.obs import ObsConfig
    return FLConfig(num_devices=64, available_prob=0.3, batch_size=32,
                    tau=1, scheduler=sched_name, scheduler_backend="torch",
                    seed=0, eval_every=3,
                    obs=ObsConfig(enabled=True, ring_size=ring_size))


def phase_main_path(torch, dev, prof_ok):
    from repro_torch.core import scheduling as S
    from repro_torch.fl import FederatedTrainer
    from repro_torch.kernels import common

    class CheckedTrainer(FederatedTrainer):
        """Keeps every (Problem, Schedule) the round solved, and the
        inputs and result of every Eq. 10 sigma call."""

        def _schedule(self, prob, *a):
            sched = super()._schedule(prob, *a)
            self.solved.append((prob, sched))
            return sched

        def _sigma_all(self, params, images, labels):
            sigma = super()._sigma_all(params, images, labels)
            self.sigmas.append((params, images, labels, sigma))
            return sigma

    t0 = time.perf_counter()
    model, train, test, parts = fl_world()
    log(f"main path data: {len(train)} train / {len(test)} test images "
        f"32x32x3, 64 devices ({time.perf_counter() - t0:.2f} s)")

    def new_trainer(sched_name):
        tr = CheckedTrainer(model, train, test, parts, fl_config(sched_name))
        tr.solved, tr.sigmas = [], []
        return tr

    trainers = {}
    sigma_err = []
    common.reset_launches()
    for sched_name, solve in (("fedcgd-fscd", S.fscd),
                              ("fedcgd-gs", S.greedy_scheduling)):
        tr = new_trainer(sched_name)
        for j in range(3):
            rec = tr.run_round(j)
            sigma_err.append(check_round(
                torch, tr, solve, f"{sched_name} round {j}", rec))
        require(all(bool(torch.isfinite(p).all())
                    for p in tr.params.values()),
                f"{sched_name}: params not finite")
        recs = tr.obs.records()
        c = tr.obs.metrics.counters
        syncs = c["sched.host_syncs.torch"].value
        calls = c["sched.solve_many_calls.torch"].value
        for r in recs:
            ph = " ".join(f"{k}={v * 1e3:.2f}ms"
                          for k, v in r["phases"].items())
            log(f"{sched_name} round {r['round']}: round={r['round_s'] * 1e3:.2f}"
                f"ms {ph} | avail={r['num_available']} "
                f"sched={r['num_scheduled']} loss={r['mean_local_loss']:.4f}"
                f" sched_iters={r['sched_iterations']} host_syncs="
                f"{r['host_syncs']}")
        log(f"{sched_name}: {syncs / calls:.1f} scheduler host syncs per "
            f"solve ({int(calls)} solves)")
        trainers[sched_name] = (tr, solve)
    launches = dict(common.LAUNCHES)
    shapes = dict(common.LAST_SHAPES)
    log(f"main path launches: {launches}")
    for name in FL_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the main path")
    tr, _ = trainers["fedcgd-fscd"]
    twin = new_trainer("fedcgd-fscd")
    for j in range(3):
        twin.run_round(j)
    check_same_run(torch, tr, twin, "fedcgd-fscd")
    if prof_ok:
        for sched_name, (tr, solve) in trainers.items():
            sigma_err.append(profile_round(torch, sched_name, tr, solve))
    abs_err, rel_err, top = (max(e[i] for e in sigma_err) for i in range(3))
    log(f"main path sigmas (persample_gradnorm kernel) vs closed form: "
        f"max abs err {abs_err:.3g}, max rel err {rel_err:.3g}, largest "
        f"sigma {top:.4g}")
    return launches, shapes


def check_same_run(torch, a, b, tag):
    """Two trainers on one seed after the same rounds: bitwise-equal
    history (the round records), masks, iteration counts, Eq. 10 sigmas
    and params."""
    import numpy as np
    require(a.history == b.history,
            f"{tag}: two trainers on one seed differ in their history")
    require(len(a.solved) == len(b.solved) and all(
        np.array_equal(sa.mask, sb.mask) and sa.iterations == sb.iterations
        for (_, sa), (_, sb) in zip(a.solved, b.solved)),
        f"{tag}: two trainers on one seed differ in masks or iterations "
        f"{[s.iterations for _, s in a.solved]} / "
        f"{[s.iterations for _, s in b.solved]}")
    require(all(torch.equal(x[3], y[3]) for x, y in zip(a.sigmas, b.sigmas)),
            f"{tag}: two trainers on one seed differ in their sigmas")
    differ = [k for k in a.params if not torch.equal(a.params[k],
                                                     b.params[k])]
    require(not differ, f"{tag}: two trainers on one seed differ in params "
            f"{differ}")
    log(f"{tag}: a second trainer on the same seed gave a bitwise-equal "
        f"history, masks, iterations "
        f"{[s.iterations for _, s in b.solved]}, sigmas and params after "
        f"{len(b.history)} rounds (cudnn deterministic "
        f"{torch.backends.cudnn.deterministic}, benchmark "
        f"{torch.backends.cudnn.benchmark})")


def profile_round(torch, sched_name, tr, solve) -> tuple:
    """One more round (index 4: no evaluation in it) under
    ``torch.profiler``, held to ``check_round``'s checks: the device's
    busy share of the round's wall time (summed kernel and copy time
    over the host clock, the profiler's own cost included, so a lower
    bound), the kernels that took longest and the port's kernel launches
    in the round.  Returns the round's sigma errors."""
    import collections

    from repro_torch.kernels import common
    before = collections.Counter(common.LAUNCHES)
    rec = profiled(torch, f"{sched_name} profiled round",
                   lambda: tr.run_round(4))
    log(f"{sched_name} profiled round: kernel launches "
        f"{dict(common.LAUNCHES - before)}")
    return check_round(torch, tr, solve, f"{sched_name} profiled round", rec)


def profiled(torch, tag, fn, top=6):
    """Run ``fn`` once under ``torch.profiler`` and log the device's busy
    share of its wall time (summed kernel and copy time over the host
    clock, the profiler's own cost included, so a lower bound) and the
    kernels that took longest.  Returns what ``fn`` returns."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    log(f"{tag}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.3f} ms"
        f" ({100 * busy / wall:.1f}%), {sum(e.count for e in evs)} device "
        f"ops; longest: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in evs[:top]))
    return out


def lm_consistency(torch, model, params, prompts, P, C):
    """Prefill of P tokens plus C teacher-forced ``serve_step``s (the
    plain decode route) against one prefill of P+C tokens (the kernel
    route) at those positions.  Returns (max abs error over max(1,
    max |logit|), relative L2 error, warm prefill ms, max(1, max
    |logit|))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _, cache = model.forward(params, {"tokens": prompts[:, :P]},
                                     collect_cache=True, cache_len=P + C + 8)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    del logits
    dec = []
    for i in range(C):
        step, cache = model.serve_step(params, cache,
                                       {"tokens": prompts[:, P + i:P + i + 1]})
        dec.append(step[:, 0])
    dec = torch.stack(dec, dim=1)
    full, _, _ = model.forward(params, {"tokens": prompts[:, :P + C]})
    require(bool(torch.isfinite(full).all()), "prefill logits not finite")
    want = full[:, P:P + C].clone()
    del full, cache
    scale = max(1.0, float(want.abs().max()))
    err = float((dec - want).abs().max()) / scale
    rel = float((dec - want).norm() / want.norm())
    return err, rel, prefill_ms, scale


def phase_lm(torch, dev, prof_ok):
    """Serve recurrentgemma-2b, then rwkv6-3b, through ``generate`` at
    full width and depth (bf16), each held to the launch counts and the
    prefill/decode consistency bounds; first the same consistency check
    on each reduced config in f32.  Returns the serving runs' launches and
    kernel shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models.registry import build_model
    from repro_torch.serve import generate
    launches, shapes = {}, {}
    for arch, want_launches in LM_PREFILL_LAUNCHES.items():
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        params = model.init(gen)
        prompts = torch.randint(0, cfg.vocab_size, (2, 108), generator=gen,
                                device=dev)
        err, rel, _, _ = lm_consistency(torch, model, params, prompts, 100,
                                        8)
        log(f"{cfg.name} f32 prefill(100)+8 steps vs prefill(108): max err"
            f" {err:.3g} x scale, rel L2 {rel:.3g}")
        require(err <= F32_CONSISTENCY,
                f"{cfg.name}: decode disagrees with prefill")

        cfg = get_config(arch)
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = model.init(gen)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(x.numel() for x in _leaves(params))
        prompts = torch.randint(0, cfg.vocab_size,
                                (LM_BATCH, LM_PROMPT + LM_CHECK),
                                generator=gen, device=dev)
        common.reset_launches()
        toks, st = generate(model, params, prompts[:, :LM_PROMPT], LM_GEN,
                            temperature=0.8, generator=gen)
        got = dict(common.LAUNCHES)
        log(f"{arch}: {n_params / 1e9:.3f} B params ({cfg.param_dtype}, "
            f"{cfg.num_layers} layers, d_model {cfg.d_model}) drawn on the "
            f"card in {t_init:.2f} s; first prefill {LM_BATCH}x{LM_PROMPT} "
            f"{st['prefill_ms']:.2f} ms, decode {LM_GEN} tokens "
            f"{st['decode_tokens_per_s']:.2f} tok/s ({st['decode_s']:.3f} s);"
            f" launches prefill {st['launches_prefill']} decode "
            f"{st['launches_decode']}; seq 0: {toks[0].tolist()}")
        require(got == want_launches and st["launches_prefill"] == got
                and st["launches_decode"] == {},
                f"{arch}: launches {got}, decode {st['launches_decode']}, "
                f"want {want_launches} in prefill and none in decode")
        require(tuple(toks.shape) == (LM_BATCH, LM_GEN)
                and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
                f"{arch}: sampled tokens out of range")
        launches.update(got)
        shapes.update(common.LAST_SHAPES)
        bounds = BF16_CONSISTENCY[arch]
        err, rel, warm_ms, scale = lm_consistency(
            torch, model, params, prompts, LM_PROMPT, LM_CHECK)
        log(f"{arch}: warm prefill {LM_BATCH}x{LM_PROMPT} {warm_ms:.2f} ms; "
            f"bf16 prefill({LM_PROMPT})+{LM_CHECK} steps vs prefill("
            f"{LM_PROMPT + LM_CHECK}): max err {err:.4g} x scale, rel L2 "
            f"{rel:.4g} (bounds {bounds}, max |logit| {scale:.4g});"
            f" peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require(err <= bounds[0] and rel <= bounds[1],
                f"{arch}: decode disagrees with prefill")
        gaps = []
        for depth in LM_DEPTHS[arch]:
            sub, sub_params = first_layers(cfg, params, depth)
            e, r, _, sc = lm_consistency(torch, build_model(sub), sub_params,
                                         prompts, LM_PROMPT, LM_CHECK)
            gaps.append(f"{depth} layers {e:.4g} / {r:.4g} (max |logit| "
                        f"{sc:.4g})")
            require(e <= bounds[0] and r <= bounds[1],
                    f"{arch}: decode disagrees with prefill over the first "
                    f"{depth} layers")
        log(f"{arch}: bf16 prefill/decode gap (max err x scale / rel L2) "
            f"over the first layers: " + "; ".join(gaps)
            + f"; {cfg.num_layers} layers {err:.4g} / {rel:.4g}")
        if prof_ok:
            profile_serving(torch, model, params, prompts[:, :LM_PROMPT], arch)
        del params, model, prompts
        torch.cuda.empty_cache()
    return launches, shapes


def profile_serving(torch, model, params, prompt, arch):
    """One warm prefill and one warm decode step under the profiler."""
    def prefill():
        logits, _, cache = model.forward(params, {"tokens": prompt},
                                         collect_cache=True,
                                         cache_len=prompt.shape[1] + 8)
        return logits[:, -1].argmax(-1)[:, None], cache

    tok, cache = profiled(torch, f"{arch} profiled prefill", prefill, top=8)
    model.serve_step(params, cache, {"tokens": tok})     # warm-up
    profiled(torch, f"{arch} profiled decode step",
             lambda: model.serve_step(params, cache, {"tokens": tok}))


def first_layers(cfg, params, depth):
    """(config, params) of the model made of the first ``depth`` layers
    (whole pattern periods) and the same embedding and head: views of the
    stacked period weights, no copy."""
    import dataclasses
    sub = dataclasses.replace(cfg, num_layers=depth)
    require(depth < cfg.num_layers and sub.num_remainder_layers == 0,
            f"{depth} is not a prefix of whole periods")

    def take(tree):
        return ({k: take(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[:sub.num_full_periods])
    out = {k: v for k, v in params.items()
           if k != "blocks" and not k.startswith("rem")}
    out["blocks"] = take(params["blocks"])
    return sub, out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def timing_case(torch, dev, name, shp):
    """(kernel call, plain call, library call or None, tolerance, bytes
    per element) for one kernel at shapes ``shp``.  For attention the
    library call (bf16 tensor cores, bf16 probabilities) is held to the
    plain version at the sweep's 3e-2 only."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched)
    from repro_torch.kernels.rglru_scan import rglru_cuda
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    from repro_torch.kernels.wemd_swap import wemd_add_cuda, wemd_swap_cuda
    if name == "attention":        # at the model's dtype, bf16
        (B, H, S, hd), (_, KV, T, _), (causal, window) = shp
        q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, torch.bfloat16, 92,
                              dev)
        kx, vx = (x.repeat_interleave(H // KV, dim=1) for x in (k, v))
        mask = window_mask(torch, S, T, causal, window, dev)
        return (lambda: flash_attention_cuda(q, k, v, causal=bool(causal),
                                             window=window),
                lambda: ref.attention_ref(q, k, v, causal=bool(causal),
                                          window=window),
                lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                       attn_mask=mask),
                BF16_ATTN_TOL, 2)
    if name == "wkv":
        (B, T, H, hd), = shp
        args = wkv_inputs(torch, B, T, H, hd, 93, dev)
        return (lambda: wkv_cuda(*args)[0], lambda: ref.wkv_ref(*args)[0],
                None, (2e-3, 1e-3), 4)
    if name == "rglru":
        (B, T, D), = shp
        args = rglru_inputs(torch, B, T, D, 94, dev)
        return (lambda: rglru_cuda(*args)[0], lambda: ref.rglru_ref(*args)[0],
                None, (1e-5, 1e-5), 4)
    if name == "persample_gradnorm":
        (V, B, d), (_, _, C) = shp
        args = psg_inputs(torch, V, B, d, C, 90, dev)
        return (lambda: persample_gradnorm_cuda_batched(*args)[0],
                lambda: ref.persample_gradnorm_ref(*args)[0], None,
                (SIGMA_ATOL, SIGMA_RTOL), 4)
    (B, V, C), = shp
    args = wemd_inputs(torch, B, V, C, max(1, min(5, V)), 91, dev)
    if name == "wemd_add":
        kern, plain = wemd_add_cuda, ref.wemd_add_ref
        x, y = cdist_add(torch, *args)
    else:
        kern, plain = wemd_swap_cuda, ref.wemd_swap_ref
        x, y = cdist_swap(torch, *args)
    return (lambda: kern(*args), lambda: plain(*args),
            lambda: torch.cdist(x, y, p=1), (1e-5, 1e-5), 4)


def wemd_path(torch, dev, name, shp):
    """The call as the scheduler makes it: ``ops.wemd_*`` on f64 inputs at
    shapes ``shp``, held bitwise to the kernel's call on the f32-cast
    inputs.  Returns the call."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wemd_swap import wemd_add_cuda, wemd_swap_cuda
    (B, V, C), = shp
    a64 = wemd_inputs(torch, B, V, C, max(1, min(5, V)), 91, dev,
                      torch.float64)
    a32 = [a.float() for a in a64]
    op, kern = ((ops.wemd_add, wemd_add_cuda) if name == "wemd_add"
                else (ops.wemd_swap, wemd_swap_cuda))
    got, want = op(*a64), kern(*a32)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"{name}: ops on f64 inputs is not the "
            f"kernel on the f32-cast inputs at {shp}")
    return lambda: op(*a64)


def attention_f32_check(torch, dev, shp):
    """The attention kernel on f32 inputs at the path's shape against its
    plain version; returns the max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    (B, H, S, hd), (_, KV, T, _), (causal, window) = shp
    q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, torch.float32, 95, dev)
    got = flash_attention_cuda(q, k, v, causal=bool(causal), window=window)
    want = ref.attention_ref(q, k, v, causal=bool(causal), window=window)
    torch.cuda.synchronize()
    err = (got - want).abs()
    require(bool((err <= F32_ATTN_TOL[0]
                  + F32_ATTN_TOL[1] * want.abs()).all()),
            f"attention f32: max abs err {float(err.max()):.3g} over "
            f"tolerance at {shp}")
    return float(err.max())


def phase_timing(torch, dev, launches, shapes, prof_ok):
    rows = []
    for name in TPU_KERNELS:
        shp = shapes[name]
        kern, plain, library, (atol, rtol), itemsize = timing_case(
            torch, dev, name, shp)
        got, want = kern().float(), plain().float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(bool(((got - want).abs() <= atol + rtol * want.abs()).all()),
                f"{name}: max abs err {err:.3g} over tolerance at {shp}")
        rel = float((got - want).norm() / want.norm())
        if library is not None:
            lib_tol = (3e-2, 3e-2) if name == "attention" else (atol, rtol)
            lib_out = library().float().reshape(want.shape)
            require(bool(torch.allclose(lib_out, want, atol=lib_tol[0],
                                        rtol=lib_tol[1])),
                    f"{name}: the library yardstick computes another "
                    f"function")
        if name == "attention":
            log(f"attention at {shp}: bf16 max abs err {err:.3g} (atol "
                f"{atol} + rtol {rtol}), rel L2 {rel:.3g}; f32 max abs err "
                f"{attention_f32_check(torch, dev, shp):.3g} (atol "
                f"{F32_ATTN_TOL[0]} + rtol {F32_ATTN_TOL[1]})")
        ms = time_ms(torch, kern)
        clock_power = smi("clocks.sm,power.draw")
        plain_ms = time_ms(torch, plain)
        lib_ms = time_ms(torch, library) if library else None
        b_ms, b_by = bound(name, shp, itemsize)
        route, src = SOURCES[name]
        row = {"name": name, "route": route, "source": src,
               "replaces": TPU_KERNELS[name],
               "launches": int(launches[name]), "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib_ms,
               "device_ms": device_ms(torch, kern) if prof_ok else None,
               "plain_device_ms": (device_ms(torch, plain)
                                   if prof_ok else None),
               "sm_clock_power_after": clock_power,
               "shape": [list(s) for s in shp]}
        if name in ("wemd_add", "wemd_swap"):
            row["path_ms"] = time_ms(torch, wemd_path(torch, dev, name, shp))
        if name == "attention":
            # the rate over the visible pairs (4 hd FLOPs each) and the
            # share of the bound, both from the device time (else ms)
            t = row["device_ms"] or ms
            (B, H, S, hd), (_, _, T, _), (causal, window) = shp
            flops = 4 * hd * B * H * visible_pairs(S, T, causal, window)
            row["tflops"] = flops / t / 1e9
            row["bound_share"] = b_ms / t
            log(f"attention bf16 at {shp}: {row['tflops']:.1f} TFLOP/s over "
                f"the visible pairs, {100 * row['bound_share']:.1f} % of the "
                f"bound ({b_ms:.4f} ms over {t:.4f} ms); library "
                f"{lib_ms:.4f} ms")
        if name == "wkv":
            t = row["device_ms"] or ms
            row["bound_share"] = b_ms / t
            log(f"wkv at {shp}: {100 * row['bound_share']:.1f} % of the bound "
                f"({b_ms:.4f} ms over {t:.4f} ms)")
        rows.append(row)
    log("kernels: " + "; ".join(
        f"{r['name']} median {r['ms']:.4f} ms per call"
        + (f" (path {r['path_ms']:.4f} ms)" if "path_ms" in r else "")
        + f", device "
        f"{r['device_ms']} ms, at {r['shape']} (plain {r['plain_ms']:.4f}"
        f" ms, library {r['library_ms']} ms, bound {r['bound_ms']:.6f} ms, "
        f"max abs err {r['max_abs_err']:.3g}; SM clock, power just after: "
        f"{r['sm_clock_power_after']})" for r in rows))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    card = smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    for name, fn in (("build", phase_build),
                     ("kernel checks", phase_kernel_checks),
                     ("scheduler parity", phase_scheduler)):
        t0 = time.perf_counter()
        fn(torch, dev)
        log(f"[{name}] done in {time.perf_counter() - t0:.2f} s")
    prof_ok = profiler_works(torch)
    t0 = time.perf_counter()
    launches, shapes = phase_main_path(torch, dev, prof_ok)
    log(f"[main path] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lm_launches, lm_shapes = phase_lm(torch, dev, prof_ok)
    launches.update(lm_launches)
    shapes.update(lm_shapes)
    log(f"[LM serving] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rows = phase_timing(torch, dev, launches, shapes, prof_ok)
    log(f"[timing] done in {time.perf_counter() - t0:.2f} s; "
        f"total {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
