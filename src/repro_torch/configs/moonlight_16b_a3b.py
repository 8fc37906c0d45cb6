"""moonlight-16b-a3b [moe]: Moonlight-16B-A3B as published (DeepSeek-V3's
architecture, ``model_type`` deepseek_v3).  [hf:moonshotai/Moonlight-16B-A3B,
https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json]

27 layers, d_model 2048, vocab 163840, RMSNorm eps 1e-5, RoPE theta 50000
(no scaling), untied embeddings, no embedding scale.  Layer 0 is dense
(SwiGLU 11264); layers 1-26 are MoE: 64 routed experts of width 1408, 6
a token, and 2 shared experts (one SwiGLU of 2816).  Routing: sigmoid
scores, the choice the top 6 of score + correction bias (noaux_tc, one
group), the weights the chosen scores normalised and times 2.446, no
assignment dropped.  Attention is latent (MLA): 16 heads, kv_lora_rank
512, no q_lora_rank, q/k heads [nope 128 | rope 64], v heads 128 (the
layer is ``models/mla.py``).

This is the port's only configuration that the JAX package does not
have; ``moonshot-v1-16b-a3b`` is the JAX package's simplified model under
the same citation.  Departures from the published model, each a fixed
reparametrisation: every RMSNorm is ``x * (1 + scale)`` (the port's
convention; the published weight is 1 + scale), RoPE rotates the halves
of the 64 rope channels (HF's DeepSeek-V3 interleaves them: a fixed
permutation of W_q's and W_kva's rope columns), and the correction bias
is a buffer that the train step leaves as it is.

``experts_held`` / ``expert_lo`` give the experts this device holds (all
64 here); the benchmark's cell holds 8 of them, one chip's share of an
8-way expert-parallel layer.  Serving needs a latent KV cache, which the
port does not have: ``serve.py`` and a ``ShardingCtx`` refuse this config.
"""
import dataclasses

from repro_torch.configs.base import MLA, MLA_DENSE, ModelConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A ``ModelConfig`` with latent attention, leading dense layers and a
    sigmoid router; every field of the base keeps its meaning (``d_ff``
    the routed experts' width, ``num_shared_experts`` the shared SwiGLU's
    multiple of it), ``head_dim`` is the q/k head size (nope + rope).
    Its layers are of kind ``MLA_DENSE`` (the first) and ``MLA`` (the
    periods); its embeddings are not scaled."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense: int = 1          # leading dense layers (``first``)
    dense_ff: int = 11264           # their SwiGLU width
    router_score: str = "sigmoid"
    routed_scaling: float = 2.446
    experts_held: int = 0           # experts this device holds; 0: all
    expert_lo: int = 0              # the first of them
    drop_free: bool = True
    norm_eps: float = 1e-5
    embed_scale = False
    first_kind = MLA_DENSE

    @property
    def num_full_periods(self) -> int:
        return (self.num_layers - self.first_k_dense) // self.pattern_period

    @property
    def num_remainder_layers(self) -> int:
        return (self.num_layers - self.first_k_dense) % self.pattern_period

    def layer_kind(self, layer_idx: int) -> str:
        if layer_idx < self.first_k_dense:
            return self.first_kind
        return super().layer_kind(layer_idx - self.first_k_dense)

    @property
    def num_held(self) -> int:
        return self.experts_held or self.num_experts

    def reduced(self, **overrides) -> "MLAConfig":
        """A CPU-sized form with every layer kind: the dense layer and two
        MoE layers, 8 experts of which 4 are held, 2 a token, every width
        cut."""
        kw = dict(num_layers=3, num_kv_heads=4, num_shared_experts=2,
                  head_dim=48, kv_lora_rank=64,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                  d_ff=64, dense_ff=256, num_experts=8, experts_per_token=2,
                  experts_held=4)
        kw.update(overrides)
        return super().reduced(**kw)

    def validate(self) -> None:
        super().validate()
        assert self.head_dim == self.qk_nope_head_dim + self.qk_rope_head_dim
        assert self.block_pattern == (MLA,), self.name
        assert self.router_score == "sigmoid" and self.drop_free, self.name
        assert 0 <= self.expert_lo
        assert self.expert_lo + self.num_held <= self.num_experts
        # one leading dense layer: the ``first`` tree of the params
        assert self.first_k_dense == 1 < self.num_layers, self.name


CONFIG = MLAConfig(
    name="moonlight-16b-a3b",
    family="moe",
    source="https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/"
           "config.json",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,
    d_ff=1408,
    vocab_size=163840,
    block_pattern=(MLA,),
    rope_theta=50_000.0,
    tie_embeddings=False,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    capacity_factor=0.0,
    router_aux_loss=0.0,
)
