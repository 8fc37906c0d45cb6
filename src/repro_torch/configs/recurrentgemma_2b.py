"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000. Griffin: RG-LRU recurrent blocks + local attention at a
2:1 recurrent:attention pattern, window 2048. [arXiv:2402.19427]"""
from repro_torch.configs.base import LOCAL_ATTN, RECURRENT, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=(RECURRENT, RECURRENT, LOCAL_ATTN),
    window_size=2048,
    lru_width=2560,
    conv1d_width=4,
    pos_embedding="rope",
    tie_embeddings=True,
)
