"""The paper's own CIFAR-10 CNN (Section VI-A) and ResNet18-GN (CIFAR-100).

The CNN: two conv blocks (2x conv3x3-32 + maxpool + dropout0.2,
2x conv3x3-64 + maxpool + dropout0.3), FC-120, softmax-10.
ResNet18 with every BatchNorm replaced by GroupNorm [50] to make FL on
heterogeneous data converge.

These use a separate config type because they are vision CNNs, not
sequence models; models/cnn.py consumes them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    kind: str                 # "paper_cnn" | "resnet18_gn"
    num_classes: int
    image_size: int = 32
    channels: int = 3
    dropout: bool = True
    gn_groups: int = 8        # for resnet18_gn
    width: float = 1          # channel multiplier; may be fractional
    #   (micro benchmark variants round channels to >= 1)

    def reduced(self) -> "CNNConfig":
        return dataclasses.replace(self, name=self.name + "-reduced",
                                   image_size=16, dropout=False)


PAPER_CNN_CIFAR10 = CNNConfig(name="paper-cnn-cifar10", kind="paper_cnn",
                              num_classes=10)
RESNET18_GN_CIFAR100 = CNNConfig(name="resnet18-gn-cifar100",
                                 kind="resnet18_gn", num_classes=100)
