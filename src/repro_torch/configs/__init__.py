from repro_torch.configs.paper_cnn import (CNNConfig,  # noqa: F401
                                           PAPER_CNN_CIFAR10)
