#!/usr/bin/env python3
"""Time the WEMD kernels' call path, step by step, on one NVIDIA GPU.

    python3 scripts/wemd_call_path.py [--src CHECKOUT] [--label NAME]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout),
so that two trees can be timed in one run on one card, in turns.  At the
FL round's shapes (the add row at [1, 23, 10], the swap matrix at
[32, 23, 10]; ``chip_smoke.py``'s inputs, seed 91) it measures:

  ms, path_ms, cdist_ms   the median per-call time by CUDA events
                          (``chip_smoke.time_ms``) of the kernel's wrapper
                          on f32 inputs, of ``ops.wemd_*`` on f64 inputs
                          (the scheduler's call) and of ``torch.cdist``
                          on the same function (the yardstick);
  kernel_host_us, path_host_us
                          the host time of the first two calls, in us a
                          call, by the host clock (``host_us``);
  device_ms, path_device_ms, path_device_ops
                          last, from a ``torch.profiler`` trace: the wrapper's
                          device time a call, and the path's device time
                          and device operations (kernels and copies) a
                          call;
  steps_us                for a tree with the ctypes launcher
                          (``kernels/wemd_swap.py:_launchers``), the host
                          time of each step of the path in us a call, by
                          the host clock over 2000 calls (median of 5):
                          the dispatcher's argument pass, the validation,
                          the output's ``new_empty``, the six
                          ``data_ptr`` reads, the raw stream, the ctypes
                          launch (with the C launcher's device check),
                          ``count_launch``; and, for comparison, the
                          steps it replaced (a stream object, a
                          ``torch.cuda.device`` context, five f64 -> f32
                          casts).

Prints the card's name and power limit, then one JSON object as the last
line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"wemd_add": (1, 23, 10), "wemd_swap": (32, 23, 10)}


def host_us(torch, fn, n=2000, reps=5):
    """Median over ``reps`` of the host time a call of ``n`` back-to-back
    calls, in us, after a warm-up; the device is synchronised between
    repetitions, not inside them."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def device_ops(torch, fn, n=50):
    """(device ms, device operations) a call from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in evs) / n / 1e3,
            sum(e.count for e in evs) / n)


def steps(torch, K, ops, name, a64):
    """Host us a call of each step of ``ops.<name>`` on f64 inputs."""
    from repro_torch.kernels import common
    B, V, C, flag, dev = K._check(*a64)
    which = 0 if name == "wemd_add" else 1
    out_shape = (B, V) if which == 0 else (B, V, V)
    fn = K._launchers()[which]
    p_dev = a64[1]
    out = p_dev.new_empty(out_shape, dtype=torch.float32)
    ptrs = [a.data_ptr() for a in a64] + [out.data_ptr()]
    stream = torch._C._cuda_getCurrentRawStream(dev)

    def device_context():
        with torch.cuda.device(p_dev.device):
            pass
    return {
        "dispatch_args": host_us(torch, lambda: ops._wemd_cuda_args(a64)),
        "check": host_us(torch, lambda: K._check(*a64)),
        "new_empty": host_us(torch, lambda: p_dev.new_empty(
            out_shape, dtype=torch.float32)),
        "data_ptr_x6": host_us(torch, lambda: [a.data_ptr() for a in a64]
                               + [out.data_ptr()]),
        "raw_stream": host_us(
            torch, lambda: torch._C._cuda_getCurrentRawStream(dev)),
        "ctypes_launch": host_us(
            torch, lambda: fn(*ptrs, B, V, C, flag, dev, stream)),
        "count_launch": host_us(
            torch, lambda: common.count_launch(name, p_dev.shape)),
        "replaced_stream_object": host_us(
            torch, lambda: torch.cuda.current_stream(p_dev.device).cuda_stream),
        "replaced_device_context": host_us(torch, device_context),
        "replaced_f32_casts_x5": host_us(
            torch, lambda: [a.to(torch.float32).contiguous() for a in a64]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                 # puts ROOT/src on the path
    import torch
    if not torch.cuda.is_available():
        print("wemd_call_path: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve() / "src"
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import wemd_swap as K
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    dev = torch.device("cuda")
    print(cs.smi(), flush=True)
    result = {"label": args.label, "src": str(src),
              "card": cs.smi(), "kind": torch.cuda.get_device_name(0)}
    cases = {}
    for name, (B, V, C) in SHAPES.items():
        a64 = cs.wemd_inputs(torch, B, V, C, 5, 91, dev, torch.float64)
        a32 = [a.float() for a in a64]
        kern = (getattr(K, f"{name}_cuda", None)
                or getattr(K, f"{name}_triton"))
        op = getattr(ops, name)
        x, y = (cs.cdist_add if name == "wemd_add" else cs.cdist_swap)(
            torch, *a32)
        got, path = kern(*a32), op(*a64)
        torch.cuda.synchronize()
        cs.require(torch.equal(got, path), f"{name}: the path's output is "
                   "not the kernel's on the cast inputs")
        cases[name] = (lambda: kern(*a32), lambda: op(*a64))
        # host and event timings first, the profiler traces last, so that
        # no timing runs after a profiler session
        row = {"shape": [B, V, C], "kernel": kern.__name__,
               "ms": cs.time_ms(torch, cases[name][0]),
               "path_ms": cs.time_ms(torch, cases[name][1]),
               "cdist_ms": cs.time_ms(torch,
                                      lambda: torch.cdist(x, y, p=1)),
               "kernel_host_us": host_us(torch, cases[name][0]),
               "path_host_us": host_us(torch, cases[name][1])}
        if hasattr(K, "_launchers"):
            row["steps_us"] = steps(torch, K, ops, name, a64)
        result[name] = row
    for name, (kern_call, path_call) in cases.items():
        row = result[name]
        row["device_ms"], _ = device_ops(torch, kern_call)
        row["path_device_ms"], row["path_device_ops"] = device_ops(
            torch, path_call)
        print(f"{args.label} {name}: {json.dumps(row)}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
