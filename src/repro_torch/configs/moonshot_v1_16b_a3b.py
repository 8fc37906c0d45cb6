"""moonshot-v1-16b-a3b [dense w/ MoE FFN]: 48L d_model=2048 16H (GQA kv=16,
i.e. MHA) expert d_ff=1408 vocab=163840, MoE 64 experts top-6 with
DeepSeek-V3-style shared experts. [hf:moonshotai/Moonlight-16B-A3B]

This mirrors the JAX package's config field for field (the tests hold it
so) and is not the published model it cites.  It departs from
Moonlight-16B-A3B in its layers (48, not 27), its attention (plain
multi-head with 128-wide heads, not latent attention), its first layer
(MoE, not dense) and its routing (softmax top-k with capacity drops, not
sigmoid scores with a bias-corrected, drop-free choice).  The published
architecture is ``moonlight-16b-a3b`` (``configs/moonlight_16b_a3b.py``).

Assumption noted in DESIGN.md: Moonlight uses 2 shared experts and a dense
first layer; we keep 2 shared experts and make every layer MoE (uniform
pattern keeps the scanned dry-run HLO small; parameter count deviates <1%).
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    block_pattern=(GLOBAL_ATTN,),
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    rope_theta=50_000.0,
)
