"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 (EnCodec codebook). Decoder-only over EnCodec tokens; the
EnCodec conv frontend is a STUB — input_specs() provides precomputed frame
embeddings. [arXiv:2306.05284]"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=(GLOBAL_ATTN,),
    pos_embedding="sinusoidal",
    num_encoder_tokens=0,     # decoder-only; frame embeddings arrive as inputs
    encoder_dim=2048,         # EnCodec frame embedding dim (stub frontend)
)
