#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not part of a
benchmark run).

  python3 portbench/calibrate.py --workload resnet18gn-fscd \\
      --seeds 11,12,13 --controls 3

For each seed, in one process: the cell's set-up (its recorded first
steps), then the compared numbers of the program against the reference
("sound"), and for the first ``--controls`` seeds those of the control,
the reference computed one precision below the configuration's in the
program's place, and of each fault a check must catch, planted in the
reference put in the program's place.  One JSON line a seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import run as _run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    _run._environment()
    import torch

    from portbench import harness
    cell = harness.Cell(args.workload)
    device = torch.device(args.device)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = cell.driver(seed=seed, device=device, tiny=args.tiny)
        driver.setup()
        setup_s = time.perf_counter() - t0
        driver.release()
        t1 = time.perf_counter()
        line = {"seed": seed, "setup_s": setup_s,
                "sound": driver.numbers()}
        line["reference_s"] = time.perf_counter() - t1
        if hasattr(driver, "worst"):
            line["sound_worst_leaves"] = driver.worst
        if hasattr(driver, "held"):
            line["held_leaves"] = driver.held
        if i < args.controls:
            line["control"] = driver.numbers(driver.CONTROL)
            for name, side in driver.FAULTS.items():
                line[name] = driver.numbers(side)
        print(json.dumps(line), flush=True)
        del driver
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
