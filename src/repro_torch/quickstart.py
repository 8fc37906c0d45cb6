"""Quickstart: one FedCGD round, end to end (counterpart of
``examples/quickstart.py``), three rounds over 16 devices.

  python -m repro_torch.quickstart                 # on the GPU
  PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.paper_cnn import PAPER_CNN_CIFAR10
from repro_torch.data import (sort_and_partition, synthetic_image_dataset,
                              train_test_split)
from repro_torch.fl import FederatedTrainer, FLConfig
from repro_torch.models.registry import build_model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "without one)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    # 1. a synthetic CIFAR-like dataset, sorted-and-partitioned over 16
    #    devices
    ds = synthetic_image_dataset(num_classes=10, num_per_class=60,
                                 image_size=16)
    train, test = train_test_split(ds)
    rng = np.random.default_rng(0)
    device_data = sort_and_partition(train.labels, 16, 1, rng)

    # 2. the paper's CNN (reduced) + the FedCGD trainer
    model = build_model(PAPER_CNN_CIFAR10.reduced())
    fl = FLConfig(num_devices=16, available_prob=0.5, batch_size=16,
                  scheduler="fedcgd-fscd", eval_every=1, device=args.device)
    trainer = FederatedTrainer(model, train, test, device_data, fl)

    # 3. each round draws the wireless channel, runs local SGD on every
    #    available device, solves P1 (WEMD + sampling variance, Lambert-W
    #    bandwidth feasible) and aggregates only the scheduled uploads
    records = []
    for j in range(args.rounds):
        rec = trainer.run_round(j)
        records.append(rec)
        print(f"round {j}: available={rec['num_available']} "
              f"scheduled={rec['num_scheduled']} wemd={rec['wemd']:.3f} "
              f"sampling_var={rec['sampling_variance']:.3f} "
              f"acc={rec.get('test_accuracy', float('nan')):.3f}")
    return records


if __name__ == "__main__":
    main()
