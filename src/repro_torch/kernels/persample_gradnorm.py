"""Eq. 10 sigma-hat kernel for a softmax-CE head (CUDA C++, sm_90a).

Replaces ``repro/kernels/persample_gradnorm.py:persample_gradnorm_pallas``.
The kernel is ``csrc/persample_gradnorm.cu`` (its header says how it is
laid out and what bounds it); it is built with ``nvcc`` on first use and
called through ``ctypes``.  Two entry points share one launcher:

  * ``persample_gradnorm_cuda``         h [B, d]    -> (sigma, gi_sq [B])
  * ``persample_gradnorm_cuda_batched`` h [V, B, d] -> (sigma [V],
    gi_sq [V, B]) — one thread block per device, one launch per round.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import count_launch, load_library

# dynamic shared memory holds the [B, C] softmax errors of one device
MAX_SHARED_BYTES = 227 * 1024


@functools.cache
def _launcher():
    lib = load_library("persample_gradnorm.cu")
    fn = lib.psg_sigma_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def persample_gradnorm_cuda_batched(features, logits, labels):
    """features [V,B,d], logits [V,B,C], labels [V,B] (CUDA) ->
    (sigma [V] f32, gi_sq [V,B] f32)."""
    if not all(isinstance(x, torch.Tensor) and x.is_cuda
               for x in (features, logits, labels)):
        raise ValueError("persample_gradnorm_cuda takes CUDA tensors only")
    if features.dim() != 3 or logits.dim() != 3 or labels.dim() != 2:
        raise ValueError("expected features [V,B,d], logits [V,B,C], "
                         "labels [V,B]")
    V, B, d = features.shape
    C = logits.shape[-1]
    if tuple(logits.shape[:2]) != (V, B) or tuple(labels.shape) != (V, B):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)}"
                         f", logits {tuple(logits.shape)}, labels "
                         f"{tuple(labels.shape)}")
    if B == 0 or B * C * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"batch {B} x {C} classes does not fit the "
                         f"kernel's shared memory")
    dev = features.device
    h = features.to(torch.float32).contiguous()
    lg = logits.to(device=dev, dtype=torch.float32).contiguous()
    lb = labels.to(device=dev, dtype=torch.int32).contiguous()
    gi_sq = torch.empty((V, B), dtype=torch.float32, device=dev)
    sigma = torch.empty((V,), dtype=torch.float32, device=dev)
    if V == 0:
        return sigma, gi_sq
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(h.data_ptr(), lg.data_ptr(), lb.data_ptr(),
                     gi_sq.data_ptr(), sigma.data_ptr(), V, B, d, C, stream)
    if err != 0:
        raise RuntimeError(f"persample_gradnorm launch failed: cudaError "
                           f"{err}")
    count_launch("persample_gradnorm", features.shape, logits.shape)
    return sigma, gi_sq


def persample_gradnorm_cuda(features, logits, labels):
    """features [B,d], logits [B,C], labels [B] (CUDA) ->
    (sigma scalar f32, gi_sq [B] f32)."""
    sigma, gi_sq = persample_gradnorm_cuda_batched(
        features[None], logits[None], labels[None])
    return sigma[0], gi_sq[0]
