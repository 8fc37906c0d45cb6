"""Roofline terms and model FLOPs (counterpart of
``repro/roofline/analysis.py``), with the peaks of one NVIDIA H100 SXM
from its data sheet (dense rates, no sparsity, at the 700 W power limit):

  compute term    = FLOPs / peak
  memory term     = bytes / HBM rate
  collective term = collective bytes / NVLink rate

``count_params`` and ``model_flops`` are the reference's arithmetic:
6 N_active D FLOPs for a train step of D tokens, 2 N_active D for a
forward.  The reference's ``collective_bytes_from_hlo`` reads XLA's
optimized HLO text and has no counterpart until the port is sharded.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (CROSS_ATTN, RECURRENT, RWKV,
                                      ModelConfig)

PEAK_FLOPS = 989e12        # bf16 (and fp16) on the tensor cores
TF32_FLOPS = 495e12        # TF32 on the tensor cores
F32_FLOPS = 67e12          # f32 on the CUDA cores
HBM_BW = 3.35e12           # bytes/s of HBM3
LINK_BW = 900e9            # bytes/s of NVLink to the host's other cards


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A workload's tokens: ``global_batch`` sequences of ``seq_len``
    (the reference's ``launch/shapes.py`` dataclass)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    flops_ratio: float = 0.0     # model FLOPs / (FLOPs * chips)

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, chips: int,
                   model_flops: float = 0.0) -> Roofline:
    compute = flops_per_device / PEAK_FLOPS
    memory = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW
    terms = {"compute": compute, "memory": memory, "collective": collective}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops_per_device * chips
    return Roofline(
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes_per_device,
        chips=chips,
        compute_s=compute,
        memory_s=memory,
        collective_s=collective,
        bottleneck=bottleneck,
        model_flops=model_flops,
        flops_ratio=model_flops / total_flops if total_flops else 0.0,
    )


def count_params(cfg: ModelConfig) -> tuple:
    """(total_params, active_params) from the config (analytic)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, KV, hd, dff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    total = V * d   # embedding
    active = V * d
    if not cfg.tie_embeddings:
        total += d * V
        active += d * V
    for i in range(L):
        kind = cfg.layer_kind(i)
        if kind == RWKV:
            tm = 4 * d * H * hd + H * hd * d + d * (5 * 32) + 5 * 32 * d \
                + d * 64 + 64 * d
            cm = d * dff + dff * d + d * d
            total += tm + cm
            active += tm + cm
            continue
        if kind == RECURRENT:
            lru = cfg.lru_width or d
            rec = 2 * d * lru + 2 * lru * lru + lru * d
            mlp = 3 * d * dff
            total += rec + mlp
            active += rec + mlp
            continue
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        total += attn
        active += attn
        if kind == CROSS_ATTN or not cfg.num_experts:
            mlp = 3 * d * dff
            total += mlp
            active += mlp
        else:
            E, k = cfg.num_experts, cfg.experts_per_token
            total += E * 3 * d * dff + d * E
            active += k * 3 * d * dff + d * E
            if cfg.num_shared_experts:
                sh = 3 * d * (cfg.num_shared_experts * dff)
                total += sh
                active += sh
            if cfg.moe_dense_ff:
                dr = 3 * d * cfg.moe_dense_ff
                total += dr
                active += dr
    return total, active


def model_flops(cfg: ModelConfig, shape: InputShape, kind: str) -> float:
    """6 N_active D for training, 2 N_active D for one forward/decode."""
    _, active = count_params(cfg)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch          # one new token each
    return 2.0 * active * tokens
