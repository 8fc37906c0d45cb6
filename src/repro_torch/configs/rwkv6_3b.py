"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
Finch: data-dependent per-channel decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # d_model / rwkv_head_dim
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=(RWKV,),
    rwkv_head_dim=64,
    pos_embedding="none",
)
