from repro_torch.checkpoint.ckpt import load_pytree, save_pytree  # noqa: F401
