"""Assigned input shapes (counterpart of ``repro/launch/shapes.py``):

  train_4k       seq_len=  4,096  global_batch=256   training
  prefill_32k    seq_len= 32,768  global_batch= 32   inference prefill
  decode_32k     seq_len= 32,768  global_batch=128   one token, full cache
  long_500k      seq_len=524,288  global_batch=  1   long-context decode

long_500k is for the sub-quadratic / bounded-cache archs only.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (LOCAL_ATTN, RECURRENT, RWKV,
                                      ModelConfig)

CACHE_PAD = 512   # decode caches get seq_len + CACHE_PAD slots (divisible
                  # by every mesh batch/seq axis product in use)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A workload's tokens: ``global_batch`` sequences of ``seq_len``."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def long_context_capable(cfg: ModelConfig) -> bool:
    """True if the arch has a sub-quadratic / bounded-KV path for 500k
    decode: any recurrent kind, or a local:global attention mix."""
    return bool(set(cfg.block_pattern) & {RECURRENT, RWKV, LOCAL_ATTN})


def applicable_shapes(cfg: ModelConfig):
    for name, shape in SHAPES.items():
        if name == "long_500k" and not long_context_capable(cfg):
            continue
        yield shape
