"""Model registry: a uniform functional handle over the paper's vision
models (the CIFAR-10 CNN, ResNet18-GN) and the ten LM architectures."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.models import cnn as C
from repro_torch.models import transformer as T
from repro_torch.models.layers import softmax_cross_entropy


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable             # (torch.Generator) -> params
    forward: Callable
    # vision models: (params, batch, dropout=None); LMs: (params, batch),
    # both -> (loss, metrics)
    loss_fn: Optional[Callable] = None
    dropout_shapes: Optional[Callable] = None  # (batch_size) -> mask shapes
    # the LM's decode
    init_cache: Optional[Callable] = None  # (batch, cache_len, device)
    serve_step: Optional[Callable] = None  # (params, cache, batch)

    @property
    def name(self):
        return self.cfg.name


def _cnn_model(cfg: CNNConfig) -> Model:
    def loss(params, batch, dropout=None):
        logits = C.cnn_forward(params, cfg, batch["images"], dropout)
        ce = softmax_cross_entropy(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).to(logits.dtype).mean()
        return ce, {"ce_loss": ce, "accuracy": acc}

    return Model(
        cfg=cfg,
        init=lambda gen: C.init_cnn(gen, cfg),            # on the CPU
        loss_fn=loss,
        forward=lambda params, batch, dropout=None: C.cnn_forward(
            params, cfg, batch["images"], dropout),
        dropout_shapes=lambda b: C.dropout_shapes(cfg, b),
    )


def _lm_model(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=lambda gen: T.init(gen, cfg),       # on the generator's device
        forward=lambda params, batch, **kw: T.forward(params, cfg, batch,
                                                      **kw),
        loss_fn=lambda params, batch: T.loss_fn(params, cfg, batch),
        init_cache=lambda batch, cache_len, device: T.init_cache(
            cfg, batch, cache_len, device),
        serve_step=lambda params, cache, batch: T.serve_step(
            params, cfg, cache, batch),
    )


def build_model(arch_or_cfg) -> Model:
    """A CNNConfig (``kind`` ``"paper_cnn"`` or ``"resnet18_gn"``), a
    ModelConfig, or the name of an LM architecture -> Model."""
    if isinstance(arch_or_cfg, CNNConfig):
        if arch_or_cfg.kind not in C.KINDS:
            raise ValueError(f"unknown CNN kind {arch_or_cfg.kind!r}; "
                             f"known: {C.KINDS}")
        return _cnn_model(arch_or_cfg)
    if isinstance(arch_or_cfg, ModelConfig):
        return _lm_model(arch_or_cfg)
    return _lm_model(get_config(arch_or_cfg))
