from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    make_optimizer,
    sgd,
)
