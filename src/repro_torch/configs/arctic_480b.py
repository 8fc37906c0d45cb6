"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) expert d_ff=4864
vocab=32000, MoE 128 experts top-2 PLUS a parallel dense-residual MLP
(dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base]

Assumption noted in DESIGN.md: the dense-residual intermediate size is set
to d_model (7168), matching Arctic's ~10B dense share across 35 layers.
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    block_pattern=(GLOBAL_ATTN,),
    num_experts=128,
    experts_per_token=2,
    moe_dense_ff=7168,
    rope_theta=10_000.0,
)
