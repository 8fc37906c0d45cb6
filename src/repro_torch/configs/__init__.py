"""Config registry: the paper's vision models and the LM architectures
ported so far.

``get_config`` resolves ``--arch <id>`` for the two LM architectures whose
serving path the port runs.  The JAX package's other architectures are
known by name and raise ``NotImplementedError`` until their slice lands.
"""
from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: F401
from repro_torch.configs.paper_cnn import (CNNConfig,  # noqa: F401
                                           PAPER_CNN_CIFAR10,
                                           RESNET18_GN_CIFAR100)
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B

ARCHITECTURES = {cfg.name: cfg for cfg in [RECURRENTGEMMA_2B, RWKV6_3B]}

CNN_MODELS = {
    PAPER_CNN_CIFAR10.name: PAPER_CNN_CIFAR10,
    RESNET18_GN_CIFAR100.name: RESNET18_GN_CIFAR100,
}

# the JAX package's other architectures (repro.configs.ARCHITECTURES)
NOT_PORTED = ("arctic-480b", "gemma3-27b", "llama-3.2-vision-11b",
              "moonshot-v1-16b-a3b", "musicgen-large", "qwen2-7b",
              "qwen3-moe-235b-a22b", "yi-34b")


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet (see ROADMAP.md, "
            f"Queue 1); ported: {sorted(ARCHITECTURES)}")
    if arch not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(ARCHITECTURES)}")
    cfg = ARCHITECTURES[arch]
    cfg.validate()
    return cfg


def list_archs():
    return sorted(ARCHITECTURES)
