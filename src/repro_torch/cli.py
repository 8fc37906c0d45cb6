"""End-to-end driver (paper Section VI) on the PyTorch port: wireless FL
with FedCGD or any baseline scheduler, TR 38.901 UMi channel, Table I
parameters, one cell or ``--cells N`` cells per aggregation step.

  PYTHONPATH=src python -m repro_torch.cli --scheduler fedcgd-fscd \\
      --backend torch --rounds 40 --devices 32 --classes 10

The counterpart of ``examples/wireless_fl.py``: CIFAR-10 is
replaced by a synthetic class-structured image set, everything else
(channel, Eq. 9 bandwidth, Algorithm 1/2/3, estimators) is the paper's
pipeline.  ``--device`` picks where it runs (default: the GPU; pass
``--device cpu`` to run on the CPU).  ``--cells N`` (N > 1) drives the
multi-cell engine (``MultiCellTrainer``, FedCGD schedulers only) and
reports cell 0.  ``--lossy`` arms the reference example's wireless fault
mix and server defenses, and the single knobs (``--outage-prob`` ...)
set or override its parts; ``--metrics-out PATH.jsonl`` turns on
``repro_torch.obs`` and streams one record a round to that file.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs.paper_cnn import PAPER_CNN_CIFAR10
from repro_torch.data import (apply_imbalance, dirichlet_partition,
                              sort_and_partition, synthetic_image_dataset,
                              train_test_split)
from repro_torch.faults import FaultConfig
from repro_torch.fl import FederatedTrainer, FLConfig, MultiCellTrainer
from repro_torch.models.registry import build_model
from repro_torch.obs import ObsConfig, format_summary

# the fault mix ``--lossy`` arms (``examples/wireless_fl.py``'s)
LOSSY = FaultConfig(outage_prob=0.2, dropout_prob=0.1,
                    deadline_miss_prob=0.05, corrupt_prob=0.1,
                    reshadow_std_db=4.0, outage_slack=0.2,
                    clip_delta_norm=25.0, backfill=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="fedcgd-fscd",
                    choices=["fedcgd-fscd", "fedcgd-gs", "fedcgd-fscd-gc",
                             "bc", "bn", "poc", "fcbs", "random"])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--devices", type=int, default=32)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--partition", default="sort",
                    choices=["sort", "dirichlet"])
    ap.add_argument("--shards", type=int, default=1, help="l")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--imbalance", type=float, default=1.0, help="r")
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--available-prob", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", type=int, default=1,
                    help="independent cells per aggregation step "
                         "(multi-cell engine; FedCGD schedulers only)")
    ap.add_argument("--backend", default="numpy",
                    choices=["numpy", "torch"],
                    help="P1 scheduling backend (torch = the batched "
                         "solve_many engine, with its kernels on CUDA)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--lossy", action="store_true",
                    help="enable the wireless fault model + defenses")
    ap.add_argument("--outage-prob", type=float, default=None)
    ap.add_argument("--dropout-prob", type=float, default=None)
    ap.add_argument("--corrupt-prob", type=float, default=None)
    ap.add_argument("--reshadow-std-db", type=float, default=None)
    ap.add_argument("--clip-delta-norm", type=float, default=None)
    ap.add_argument("--metrics-out", default=None, metavar="PATH.jsonl",
                    help="enable repro_torch.obs and stream per-round "
                         "metric records to this JSONL file")
    args = ap.parse_args(argv)

    ds = synthetic_image_dataset(num_classes=args.classes, num_per_class=120,
                                 image_size=16, seed=args.seed)
    train, test = train_test_split(ds, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    if args.imbalance != 1.0:
        idx = apply_imbalance(train.labels, args.imbalance, rng)
        train = dataclasses.replace(train, inputs=train.inputs[idx],
                                    labels=train.labels[idx])
    if args.partition == "sort":
        parts = sort_and_partition(train.labels, args.devices, args.shards,
                                   rng)
    else:
        parts = dirichlet_partition(train.labels, args.devices, args.alpha,
                                    rng)

    cfg = dataclasses.replace(PAPER_CNN_CIFAR10.reduced(),
                              num_classes=args.classes)
    model = build_model(cfg)
    overrides = {k: getattr(args, k) for k in
                 ("outage_prob", "dropout_prob", "corrupt_prob",
                  "reshadow_std_db", "clip_delta_norm")
                 if getattr(args, k) is not None}
    faults = dataclasses.replace(LOSSY if args.lossy else FaultConfig(),
                                 **overrides)
    obs = ObsConfig(enabled=args.metrics_out is not None,
                    jsonl_path=args.metrics_out)
    fl = FLConfig(num_devices=args.devices,
                  available_prob=args.available_prob, batch_size=16,
                  tau=args.tau, scheduler=args.scheduler,
                  scheduler_backend=args.backend, device=args.device,
                  eval_every=5, seed=args.seed, num_cells=args.cells,
                  faults=faults, obs=obs)
    if args.cells > 1:
        mc = MultiCellTrainer(model, train, test, parts, fl)
        mc.run(args.rounds, verbose=True)
        engine = mc
        trainer = mc.cells[0]           # report cell 0 below
        hist = trainer.history
        print(f"\n(multi-cell: {args.cells} cells, "
              f"{mc.solve_many_calls} scheduling calls over "
              f"{args.rounds} rounds; reporting cell 0)")
    else:
        trainer = engine = FederatedTrainer(model, train, test, parts, fl)
        hist = trainer.run(args.rounds, verbose=True)

    accs = [h["test_accuracy"] for h in hist if "test_accuracy" in h]
    print(f"\n== {args.scheduler} on {trainer.device} ==")
    print(f"max accuracy      : {max(accs):.3f}")
    print(f"avg scheduled num : {np.mean([h['num_scheduled'] for h in hist]):.2f}")
    print(f"avg WEMD          : {np.mean([h['wemd'] for h in hist]):.3f}")
    print(f"final sigma-hat   : {trainer.sigma_hat:.3f}  "
          f"G-hat: {trainer.g_hat:.3f}  "
          f"(G/sigma = {trainer.g_hat / max(trainer.sigma_hat, 1e-9):.3f})")
    if faults.injection_enabled:
        causes = {}
        for h in hist:
            for c, n in h["failure_causes"].items():
                causes[c] = causes.get(c, 0) + n
        print("\n-- failure telemetry --")
        print(f"uploads landed    : {sum(h['num_uploaded'] for h in hist)} "
              f"({sum(h['num_failed'] for h in hist)} failed)")
        print("causes            : " + ", ".join(
            f"{c}={n}" for c, n in sorted(causes.items())))
        print(f"backfilled        : {sum(h['num_backfilled'] for h in hist)}")
        print(f"sanitized deltas  : {sum(h['num_sanitized'] for h in hist)}")
    if engine.obs.enabled:
        engine.obs.close()
        print("\n== observability summary ==")
        print(format_summary(engine.obs.metrics))
        print(f"metrics written to {args.metrics_out}")


if __name__ == "__main__":
    main()
