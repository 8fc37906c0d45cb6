"""Model/config system of the LM model zoo (a copy of ``repro/configs/base.py``).

A single frozen dataclass expresses every assigned architecture family:
dense GQA transformers, MoE (incl. shared-expert and dense-residual
variants), RWKV6 (attention-free), RG-LRU hybrids (Griffin/RecurrentGemma),
VLM cross-attention decoders and audio-token decoders.

Layer heterogeneity (sliding-window vs global attention, recurrent vs
attention, self vs cross attention) is expressed with ``block_pattern``: a
tuple of layer-kind strings that repeats with period ``len(block_pattern)``.
Layer ``l`` has kind ``block_pattern[l % len(block_pattern)]``.  Parameters
of the full pattern periods are stacked on a leading axis and the remainder
layers are kept apart, as in the JAX package, so weights carry across
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer kinds understood by models/transformer.py
GLOBAL_ATTN = "global"      # full causal attention
LOCAL_ATTN = "local"        # sliding-window causal attention
CROSS_ATTN = "cross"        # cross-attention to encoder states (VLM)
RECURRENT = "recurrent"     # RG-LRU block (Griffin)
RWKV = "rwkv"               # RWKV6 time-mix block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                      # citation for the numbers below

    # trunk
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    block_pattern: Tuple[str, ...] = (GLOBAL_ATTN,)

    # attention details
    window_size: int = 0             # for LOCAL_ATTN layers
    qkv_bias: bool = False           # qwen2-style QKV bias
    qk_norm: bool = False            # gemma3-style RMSNorm on q,k
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0   # gemma3 uses a lower theta locally
    logit_softcap: float = 0.0           # final-logit soft capping (gemma)
    pos_embedding: str = "rope"          # rope | sinusoidal | none
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0      # moonlight/deepseek-style shared experts
    moe_dense_ff: int = 0            # arctic-style parallel dense-residual MLP
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01    # load-balance auxiliary loss weight

    # recurrent (RG-LRU / RWKV)
    lru_width: int = 0               # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4            # temporal conv in recurrent blocks
    rwkv_head_dim: int = 64          # RWKV6 head size

    # multimodal
    num_encoder_tokens: int = 0      # image patches / audio frames (stub frontend)
    encoder_dim: int = 0             # frontend embedding dim (projected to d_model)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True

    # cost-accounting mode (dry-run only): XLA's HloCostAnalysis counts
    # while-loop bodies ONCE, so scanned layers/chunks under-count by the
    # trip count.  With unroll_for_costing the periods and inner
    # seq-chunk loops become straight-line HLO; the dry-run compiles P=1
    # and P=2 period variants and linearly extrapolates exact totals.
    unroll_for_costing: bool = False

    # training head: number of label classes for FL classification tasks;
    # 0 means next-token prediction over vocab_size.
    num_label_classes: int = 0

    # ------------------------------------------------------------------
    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_full_periods(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def num_remainder_layers(self) -> int:
        return self.num_layers % self.pattern_period

    def layer_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % self.pattern_period]

    @property
    def attends_full_context(self) -> bool:
        """True if *every* token-mixing layer is full (global) attention.

        Used to decide long_500k eligibility: archs whose pattern contains
        only GLOBAL_ATTN / CROSS_ATTN layers have no sub-quadratic path.
        """
        kinds = set(self.block_pattern)
        return kinds <= {GLOBAL_ATTN, CROSS_ATTN}

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test variant of the same family: <=2 pattern periods,
        d_model<=256, <=4 experts, small vocab. Exercises every layer kind
        in the pattern while running a CPU forward/train step in <seconds."""
        period = self.pattern_period
        num_layers = min(self.num_layers, max(2, period))
        d_model = min(self.d_model, 256)
        head_dim = min(self.head_dim, 32) if self.head_dim else 0
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        num_kv = min(self.num_kv_heads, max(1, num_heads // 2)) if self.num_kv_heads else 0
        kw = dict(
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=max(num_kv, min(1, num_kv)),
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            window_size=min(self.window_size, 16) if self.window_size else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_dense_ff=min(self.moe_dense_ff, 128) if self.moe_dense_ff else 0,
            lru_width=min(self.lru_width, 256) if self.lru_width else 0,
            num_encoder_tokens=min(self.num_encoder_tokens, 16) if self.num_encoder_tokens else 0,
            encoder_dim=min(self.encoder_dim, 128) if self.encoder_dim else 0,
            dtype="float32",
            param_dtype="float32",
            remat=False,
        )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.num_layers > 0 and self.d_model > 0
        if self.num_heads:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        if self.num_experts:
            assert 0 < self.experts_per_token <= self.num_experts, self.name
        for kind in self.block_pattern:
            assert kind in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN, RECURRENT, RWKV)
        if LOCAL_ATTN in self.block_pattern:
            assert self.window_size > 0, self.name


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyper-parameters of one training/serving job (paper Table I defaults
    live in wireless/, not here)."""
    learning_rate: float = 0.1       # paper: eta = 0.1
    batch_size: int = 32             # paper: b = 32
    local_iters: int = 1             # paper: tau
    optimizer: str = "sgd"           # FedAvg local update is plain SGD (Eq. 1)
    momentum: float = 0.0
    weight_decay: float = 0.0
    seed: int = 0
    label_smoothing: float = 0.0
