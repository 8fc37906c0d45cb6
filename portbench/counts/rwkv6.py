"""RWKV6's parameter count from its configuration (the matrices of its
time mix, channel mix, embedding and head; norms, token-shift mixes,
decay bases and u not counted), frozen from the port's
``roofline/analysis.count_params``: 3,098,542,080 for rwkv6-3b."""
from __future__ import annotations

LORA_RANK = 32
DECAY_RANK = 64


def count_params(model: dict) -> int:
    d, L, V = model["d_model"], model["num_layers"], model["vocab_size"]
    A = model["num_heads"] * model["rwkv_head_dim"]
    dff = model["d_ff"]
    tm = 4 * d * A + A * d + 2 * d * 5 * LORA_RANK + 2 * d * DECAY_RANK
    cm = 2 * d * dff + d * d
    return (1 if model.get("tie_embeddings") else 2) * V * d + L * (tm + cm)
