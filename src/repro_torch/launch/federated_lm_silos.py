"""Cross-silo federated LM training with FedCGD scheduling (counterpart
of ``examples/federated_lm_silos.py``): silos hold token corpora with
different token-superclass distributions; each round FedCGD (the numpy
``fscd``) picks the silo group minimising WEMD + sampling variance, and
the aggregation runs as ONE schedule-weighted train step
(``make_train_step(federated=True)``, Eq. 2 as per-example loss weights).

  PYTHONPATH=src python -m repro_torch.launch.federated_lm_silos \\
      --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.federated_lm_silos --seq 256

By default it trains the full configuration on the GPU (random weights
from ``--seed``); ``--reduced`` takes the config's ``reduced()`` variant,
as the JAX example always does.  The batches are ``launch.train.lm_batch``'s
(the audio and VLM families' with their front ends' inputs).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, port_archs
from repro_torch.core import Problem, fscd
from repro_torch.data import synthetic_token_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.distributed import make_train_step, silo_weights
from repro_torch.launch.train import lm_batch
from repro_torch.models import transformer as T


def silo_world(cfg, silos: int, seq: int, superclasses: int):
    """(dataset, each silo's sequence indices, histogram function): silo
    s prefers superclass s mod C (non-IID corpora)."""
    C = superclasses
    ds = synthetic_token_dataset(cfg.vocab_size, seq + 1, num_classes=C,
                                 num_per_class=48)
    silo_idx = [np.flatnonzero(ds.labels == (s % C)) for s in range(silos)]
    bucket = max(cfg.vocab_size // C, 1)

    def histogram(tokens):
        h = np.bincount(np.minimum(tokens.reshape(-1) // bucket, C - 1),
                        minlength=C)
        return h / h.sum()

    return ds, silo_idx, histogram


def run(cfg, *, rounds: int, silos: int = 8, per_silo_batch: int = 2,
        seq: int = 64, superclasses: int = 8, eta: float = 0.05,
        device=None, seed: int = 0, params=None, log=None,
        log_every: int = 5):
    """``rounds`` FedCGD rounds over ``silos`` LM silos.  Returns (params,
    history): one record a round with the step's metrics (0-d tensors),
    the schedule's mask, its size and WEMD.  ``params`` (default: drawn
    from ``seed`` on the device) is left as it was."""
    dev = resolve_device(device)
    ds, silo_idx, histogram = silo_world(cfg, silos, seq, superclasses)
    rng = np.random.default_rng(seed)
    if params is None:
        params = T.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    step = make_train_step(cfg, eta=eta, federated=True)
    global_hist = histogram(ds.inputs)
    history = []
    for j in range(rounds):
        # each silo's round corpus and its token-superclass histogram
        takes = [rng.choice(silo_idx[s], size=per_silo_batch)
                 for s in range(silos)]
        p_dev = np.stack([histogram(ds.inputs[t]) for t in takes])
        # P1 over the silos (uniform bandwidth: datacenter silos)
        sched = fscd(Problem(p_dev=p_dev, global_dist=global_hist,
                             class_weights=np.ones(superclasses), sigma=1.0,
                             batch_size=per_silo_batch * seq,
                             min_bw=np.ones(silos), total_bw=float(silos)))
        toks = torch.from_numpy(
            ds.inputs[np.concatenate(takes)]).to(dev)      # [silos*b, seq+1]
        w = silo_weights(sched.mask, silos).repeat_interleave(
            per_silo_batch).to(dev)
        params, metrics = step(params, {**lm_batch(cfg, toks, rng),
                                        "schedule_weights": w})
        history.append({"metrics": metrics, "mask": sched.mask.copy(),
                        "scheduled": int(sched.num_scheduled),
                        "wemd": float(sched.wemd)})
        if log is not None and j % log_every == 0:
            log(f"round {j:3d} loss={float(metrics['loss']):.4f} "
                f"scheduled={sched.num_scheduled}/{silos} "
                f"wemd={sched.wemd:.3f}")
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=port_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="train the config's reduced() variant")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--silos", type=int, default=8)
    ap.add_argument("--per-silo-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--superclasses", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _, history = run(cfg, rounds=args.rounds, silos=args.silos,
                     per_silo_batch=args.per_silo_batch, seq=args.seq,
                     superclasses=args.superclasses, device=args.device,
                     seed=args.seed, log=print)
    print("final loss:", float(history[-1]["metrics"]["loss"]))


if __name__ == "__main__":
    main()
