"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Llama-architecture GQA. [arXiv:2403.04652]"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    source="arXiv:2403.04652",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=(GLOBAL_ATTN,),
    rope_theta=5_000_000.0,
)
