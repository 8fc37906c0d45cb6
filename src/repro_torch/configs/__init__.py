"""Config registry: ``--arch <id>`` resolution for the ten LM
architectures of the JAX package (each config a copy of its
``repro/configs`` file, ``list_archs``), the port's own
``moonlight-16b-a3b`` (``PORT_ONLY``; ``port_archs`` lists all eleven)
and the paper's own vision models."""
from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: F401
from repro_torch.configs.paper_cnn import (CNNConfig,  # noqa: F401
                                           PAPER_CNN_CIFAR10,
                                           RESNET18_GN_CIFAR100)
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.llama32_vision_11b import CONFIG as LLAMA32_VISION_11B
from repro_torch.configs.moonlight_16b_a3b import (  # noqa: F401
    CONFIG as MOONLIGHT_16B_A3B, MLAConfig)
from repro_torch.configs.moonshot_v1_16b_a3b import (
    CONFIG as MOONSHOT_V1_16B_A3B)
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE
from repro_torch.configs.qwen2_7b import CONFIG as QWEN2_7B
from repro_torch.configs.qwen3_moe_235b_a22b import (
    CONFIG as QWEN3_MOE_235B_A22B)
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.yi_34b import CONFIG as YI_34B

ARCHITECTURES = {
    cfg.name: cfg
    for cfg in [GEMMA3_27B, MOONSHOT_V1_16B_A3B, RWKV6_3B, QWEN2_7B,
                QWEN3_MOE_235B_A22B, YI_34B, ARCTIC_480B, RECURRENTGEMMA_2B,
                MUSICGEN_LARGE, LLAMA32_VISION_11B]
}

# configurations of the port that the JAX package does not have
PORT_ONLY = {MOONLIGHT_16B_A3B.name: MOONLIGHT_16B_A3B}

CNN_MODELS = {
    PAPER_CNN_CIFAR10.name: PAPER_CNN_CIFAR10,
    RESNET18_GN_CIFAR100.name: RESNET18_GN_CIFAR100,
}


def get_config(arch: str) -> ModelConfig:
    cfg = ARCHITECTURES.get(arch) or PORT_ONLY.get(arch)
    if cfg is None:
        raise KeyError(f"unknown arch {arch!r}; available: {port_archs()}")
    cfg.validate()
    return cfg


def list_archs():
    """The JAX package's ten architectures."""
    return sorted(ARCHITECTURES)


def port_archs():
    """Every LM architecture the port runs: the ten and ``PORT_ONLY``."""
    return sorted({**ARCHITECTURES, **PORT_ONLY})
