#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

  python3 portbench/run.py --workload resnet18gn-fscd --seed 7 \\
      --seconds 30 --trace 0

One process: set-up (inputs and weights from ``--seed``, the system
built, its first steps recorded for the correctness check and every
shape warmed), the measured window of ``--seconds``, with ``--trace 1``
a few profiled steps, then the check against the plain reference
(``portbench/reference/``), and as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``,
each compared number beside its limit (also the last lines of standard
error).  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics (``BENCHMARK.json``).

The run needs as many CUDA devices as the cell asks for and fails
without them.  ``--device cpu --tiny`` (the CPU tests' rehearsal) runs
the same path on a tiny world on the CPU.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _environment():
    """Host thread pools of one thread (the run's host work is one Python
    thread; idle pool threads that spin only steal the host's cores),
    build and kernel caches at fixed paths inside the checkout (the port's
    own nvcc builds go to ``.torch_ext_build/`` there too), and no JAX
    pulled in by a library."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"           # one process, few threads
    cache = ROOT / ".torch_ext_build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny world (the CPU tests' rehearsal)")
    return ap.parse_args(argv)


def _device_info(torch, device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def main(argv=None, t0=None):
    t0 = T0 if t0 is None else t0
    args = parse(argv)
    _environment()
    from portbench import harness
    import torch

    cell = harness.Cell(args.workload)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("portbench: no CUDA device; the benchmark does not run "
                  "on the CPU", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"devices, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
    device = torch.device(args.device)
    driver = cell.driver(seed=args.seed, device=device, tiny=args.tiny,
                         traced=bool(args.trace))
    driver.setup()
    setup_s = time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()             # set-up's objects out of the collector's scans
    steps, window_s = harness.measure(driver.step, args.seconds,
                                      getattr(driver, "finish", None))
    layer = driver.layer_data(steps) if args.trace else None
    run = harness.Run(setup_s, steps, window_s, driver, layer)
    metrics = harness.read_metrics(
        "layer_metrics" if args.trace else "end_to_end",
        cell.per_layer if args.trace else cell.end_to_end, run)
    device_info = _device_info(torch, device, cell.chips)
    if args.trace:
        rec = layer.get("trace")
        device_info["busy_s"] = rec.busy_s if rec else 0.0
        device_info["window_s"] = rec.window_s if rec else 0.0

    checks = driver.check()
    correct = harness.checks_pass(checks)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port and the "
              f"benchmark may not import them", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": len(steps), "failed": 0,
              "metrics": metrics, "device": device_info}
    if args.trace and layer.get("trace") is not None:
        rec = layer["trace"]
        result["breakdown"] = {"device_ops": rec.top_ops(),
                               "idle_gaps": rec.idle_gaps()}
    result["checks"] = harness.format_checks(checks)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
