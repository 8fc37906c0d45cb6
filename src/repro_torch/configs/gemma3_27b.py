"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt] (family card; 27B scaling per brief)."""
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    block_pattern=(LOCAL_ATTN,) * 5 + (GLOBAL_ATTN,),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    logit_softcap=0.0,
    tie_embeddings=True,
)
