"""End-to-end driver (paper Section VI) on the PyTorch port: wireless FL
with FedCGD or any baseline scheduler, TR 38.901 UMi channel, Table I
parameters, one cell.

  PYTHONPATH=src python -m repro_torch.cli --scheduler fedcgd-fscd \\
      --backend torch --rounds 40 --devices 32 --classes 10

The single-cell counterpart of ``examples/wireless_fl.py``: CIFAR-10 is
replaced by a synthetic class-structured image set, everything else
(channel, Eq. 9 bandwidth, Algorithm 1/2/3, estimators) is the paper's
pipeline.  ``--device`` picks where it runs (default: the GPU; pass
``--device cpu`` to run on the CPU).  The fault knobs (``--outage-prob``
...) arm the wireless fault model and the server defenses.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs.paper_cnn import PAPER_CNN_CIFAR10
from repro_torch.data import (apply_imbalance, dirichlet_partition,
                              sort_and_partition, synthetic_image_dataset,
                              train_test_split)
from repro_torch.faults import FaultConfig
from repro_torch.fl import FederatedTrainer, FLConfig
from repro_torch.models.registry import build_model


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
    ap.add_argument("--backend", default="numpy",
                    choices=["numpy", "torch"],
                    help="P1 scheduling backend (torch = the batched "
                         "solve_many engine, with its kernels on CUDA)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--outage-prob", type=float, default=None)
    ap.add_argument("--dropout-prob", type=float, default=None)
    ap.add_argument("--corrupt-prob", type=float, default=None)
    ap.add_argument("--reshadow-std-db", type=float, default=None)
    ap.add_argument("--clip-delta-norm", type=float, default=None)
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
    faults = FaultConfig(**overrides)
    fl = FLConfig(num_devices=args.devices,
                  available_prob=args.available_prob, batch_size=16,
                  tau=args.tau, scheduler=args.scheduler,
                  scheduler_backend=args.backend, device=args.device,
                  eval_every=5, seed=args.seed, faults=faults)
    trainer = FederatedTrainer(model, train, test, parts, fl)
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


if __name__ == "__main__":
    main()
