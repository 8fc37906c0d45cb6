"""LM training entry point: plain SGD steps (``fl.distributed.make_train_step``)
on synthetic class-structured token streams (counterpart of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.train --steps 20

By default it trains the full configuration (published width and depth,
the config's dtype) on the GPU, with random weights drawn from ``--seed``
on the device; ``--reduced`` trains the config's ``reduced()`` variant.
``--save PATH`` writes the final params with ``checkpoint.save_pytree``.
The audio family trains on random frame embeddings in place of the
tokens, and the VLM's batches carry zero encoder embeddings (the stubs
of the reference's front ends).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config, list_archs
from repro_torch.core.estimation import tree_leaves
from repro_torch.data import synthetic_token_dataset
from repro_torch.device import resolve_device
from repro_torch.fl.distributed import make_train_step
from repro_torch.models import transformer as T


def lm_batch(cfg, toks, rng):
    """The train batch of token rows ``toks`` [B, S+1], as the reference's
    ``launch/train.py`` makes it: targets the rows' last S tokens, inputs
    their first S, or for the audio family ``frame_embeddings`` [B, S,
    encoder_dim] (N(0, 1) from ``rng``); the VLM's also
    ``encoder_embeddings`` [B, num_encoder_tokens, encoder_dim] (zeros)."""
    B, S = toks.shape[0], toks.shape[1] - 1
    batch = {"targets": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frame_embeddings"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.encoder_dim), dtype=np.float32)).to(toks.device)
    else:
        batch["tokens"] = toks[:, :-1]
    if cfg.family == "vlm":
        batch["encoder_embeddings"] = torch.zeros(
            (B, cfg.num_encoder_tokens, cfg.encoder_dim), device=toks.device)
    return batch


def train(cfg, *, steps: int, batch: int, seq: int, lr: float, device,
          seed: int = 0, log_every: int = 10, log=print):
    """``steps`` SGD steps on batches of ``batch`` sequences of ``seq``
    tokens drawn (numpy, ``seed``) from ``synthetic_token_dataset``.
    Returns (params, metrics of the last step)."""
    dev = resolve_device(device)
    ds = synthetic_token_dataset(cfg.vocab_size, seq + 1, num_classes=8,
                                 num_per_class=64)
    params = T.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
        f"vocab={cfg.vocab_size} params={n_params / 1e6:.1f}M on {dev}")
    step = make_train_step(cfg, eta=lr)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    metrics = {}
    for i in range(steps):
        toks = torch.from_numpy(
            ds.inputs[rng.integers(0, len(ds.inputs), size=batch)]).to(dev)
        params, metrics = step(params, lm_batch(cfg, toks, rng))
        if i % log_every == 0 or i == steps - 1:
            log(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({(time.perf_counter() - t0) / (i + 1):.3f} s/step)")
    return params, metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="train the config's reduced() variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    ap.add_argument("--save", default=None,
                    help="write the final params here (flat npz)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params, metrics = train(cfg, steps=args.steps, batch=args.batch,
                            seq=args.seq, lr=args.lr, device=args.device,
                            seed=args.seed, log_every=args.log_every)
    print(f"done: final loss {float(metrics['loss']):.4f}")
    if args.save:
        save_pytree(args.save, params, {"arch": cfg.name,
                                        "steps": args.steps})
        print(f"params written to {args.save}")


if __name__ == "__main__":
    main()
