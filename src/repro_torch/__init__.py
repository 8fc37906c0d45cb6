"""PyTorch / CUDA port of the FedCGD reproduction (``repro``).

The package mirrors ``src/repro``'s layout and imports only torch, numpy
and scipy.  Its entry points run on the GPU unless the caller passes
``device="cpu"`` (see ``repro_torch.device.resolve_device``); on a CUDA
tensor the scheduler's candidate scans and the Eq. 10 sigma go through
the hand-written kernels in ``repro_torch.kernels``.
"""
from repro_torch.device import resolve_device  # noqa: F401
