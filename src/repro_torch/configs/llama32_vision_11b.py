"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 with gated cross-attention image layers every 5th layer.
The ViT vision encoder + projector is a STUB — input_specs() provides
precomputed patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import CROSS_ATTN, GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=(GLOBAL_ATTN,) * 4 + (CROSS_ATTN,),
    rope_theta=500_000.0,
    num_encoder_tokens=1601,   # 1 tile x (1600 patches + CLS) from the stub ViT
    encoder_dim=4096,          # already projected to d_model by the stub
)
