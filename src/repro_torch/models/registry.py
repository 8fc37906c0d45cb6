"""Model registry: a uniform functional handle (the paper CNN so far)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.models import cnn as C
from repro_torch.models.layers import softmax_cross_entropy


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable             # (torch.Generator) -> params on the CPU
    loss_fn: Callable          # (params, batch, dropout=None) -> (loss, metrics)
    forward: Callable          # (params, batch, dropout=None) -> logits
    dropout_shapes: Callable   # (batch_size) -> keep-mask shapes

    @property
    def name(self):
        return self.cfg.name


def _cnn_model(cfg: CNNConfig) -> Model:
    def loss(params, batch, dropout=None):
        logits = C.paper_cnn_forward(params, cfg, batch["images"], dropout)
        ce = softmax_cross_entropy(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).to(logits.dtype).mean()
        return ce, {"ce_loss": ce, "accuracy": acc}

    return Model(
        cfg=cfg,
        init=lambda gen: C.init_paper_cnn(gen, cfg),
        loss_fn=loss,
        forward=lambda params, batch, dropout=None: C.paper_cnn_forward(
            params, cfg, batch["images"], dropout),
        dropout_shapes=lambda b: C.dropout_shapes(cfg, b),
    )


def build_model(cfg: CNNConfig) -> Model:
    """CNNConfig -> Model (``kind="paper_cnn"``; ResNet18-GN is not
    ported yet)."""
    if not isinstance(cfg, CNNConfig) or cfg.kind != "paper_cnn":
        raise NotImplementedError(f"only the paper CNN is ported, got "
                                  f"{cfg!r}")
    return _cnn_model(cfg)
