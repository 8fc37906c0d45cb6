"""Serving entry point of the port: prefill a batch of prompts, then
decode through the KV cache and the recurrent state, a token a step.

  PYTHONPATH=src python -m repro_torch.serve --arch qwen2-7b \\
      --batch 4 --prompt-len 3072 --gen 32
  PYTHONPATH=src python -m repro_torch.serve --device cpu --reduced \\
      --arch llama-3.2-vision-11b

The counterpart of ``examples/serve_lm.py``.  Weights and prompts are
random, drawn from ``--seed`` by a ``torch.Generator`` on the device.  By
default it serves the full configuration (published width and depth, in
the config's dtype) on the GPU; ``--reduced`` serves the config's
``reduced()`` variant, as the JAX example always does.  Prefill
(``fl.distributed.make_prefill_step``: the trunk through the hand-written
kernels, the head on the last position only) and decode
(``make_serve_step``, plain torch) are the reference's serving steps.
``--temperature 0`` is greedy decoding.  The VLM's prompts come with
``num_encoder_tokens`` encoder embeddings (the stub vision encoder's
output, drawn from the seed); an audio model refuses to decode, as the
reference does: its decode steps need frame embeddings, not tokens.
"""
from __future__ import annotations

import argparse
import collections
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.fl.distributed import make_prefill_step, make_serve_step
from repro_torch.kernels import common
from repro_torch.models.registry import build_model


def sample(logits, temperature: float, generator=None):
    """logits [B, V] -> token ids [B]: argmax at temperature 0, else a
    draw from softmax(logits / temperature) with ``generator``."""
    if temperature <= 0:
        return logits.argmax(-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, prompt, gen_len: int, *, temperature=0.0,
             generator=None, extra=None):
    """Prefill ``prompt`` [B, P] (with ``extra``, more prefill inputs:
    the VLM's ``encoder_embeddings``) and decode ``gen_len`` tokens.

    Returns (tokens [B, gen_len], stats) where stats holds the prefill
    time, the decode rate and the kernel launches of each phase (from
    ``kernels.common.LAUNCHES``)."""
    if model.cfg.family == "audio":
        raise ValueError(f"{model.cfg.name}: audio decode needs frame "
                         f"embeddings; serve a token model")
    B, P = prompt.shape
    prefill_step = make_prefill_step(model.cfg, cache_len=P + gen_len + 8)
    serve_step = make_serve_step(model.cfg)
    dev = prompt.device
    launches = [collections.Counter(common.LAUNCHES)]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": prompt, **(extra or {})})
    tok = sample(logits[:, -1], temperature, generator)
    _sync(dev)
    t1 = time.perf_counter()
    launches.append(collections.Counter(common.LAUNCHES))
    out = [tok]
    for _ in range(gen_len - 1):
        logits, cache = serve_step(params, cache, {"tokens": tok[:, None]})
        tok = sample(logits[:, -1], temperature, generator)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    launches.append(collections.Counter(common.LAUNCHES))
    steps = B * (gen_len - 1)
    stats = {
        "prefill_ms": (t1 - t0) * 1e3,
        "decode_s": t2 - t1,
        "decode_tokens_per_s": steps / (t2 - t1) if steps else 0.0,
        "launches_prefill": dict(launches[1] - launches[0]),
        "launches_decode": dict(launches[2] - launches[1]),
    }
    return torch.stack(out, dim=1), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the config's reduced() smoke variant")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "audio":
        raise SystemExit("audio decode needs frame embeddings; use --arch "
                         "with a token model")
    dev = resolve_device(args.device)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    extra = None
    if cfg.family == "vlm":
        extra = {"encoder_embeddings": torch.randn(
            (args.batch, cfg.num_encoder_tokens, cfg.encoder_dim),
            generator=gen, device=dev)}
    tokens, stats = generate(model, params, prompt, args.gen,
                             temperature=args.temperature, generator=gen,
                             extra=extra)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{cfg.name} on {where}: prefill {args.batch}x{args.prompt_len} "
          f"{stats['prefill_ms']:.2f} ms; decoded {args.gen} tokens x "
          f"{args.batch} seqs, {stats['decode_tokens_per_s']:.1f} tok/s")
    print(f"kernel launches: prefill {stats['launches_prefill']}, decode "
          f"{stats['launches_decode']}")
    print("sampled token ids (seq 0):", tokens[0].tolist())


if __name__ == "__main__":
    main()
