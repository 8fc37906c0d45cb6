"""Eq. 10 sigma-hat kernel for a softmax-CE head (CUDA C++, sm_90a).

Replaces ``repro/kernels/persample_gradnorm.py:persample_gradnorm_pallas``.
The kernel is ``csrc/persample_gradnorm.cu`` (its header says how it is
laid out and what bounds it); it is built with ``nvcc`` on first use and
called through ``ctypes``.  Two entry points share one launcher:

  * ``persample_gradnorm_cuda``         h [B, d]    -> (sigma, gi_sq [B])
  * ``persample_gradnorm_cuda_batched`` h [V, B, d] -> (sigma [V],
    gi_sq [V, B]) — one thread block per device, one launch per round.

Features and logits are f32, labels int64 (as the FL round passes them)
or int32; the kernel reads them as they come, so no cast kernel runs in
front of it.  A call's time is mostly its host launch path (the kernel
takes a few us), so the path is short: one validation pass, the outputs'
``new_empty``, the current stream's raw handle, one ``ctypes`` call whose
``argtypes`` were set once.  The C launcher makes the tensors' device
current for the launch and restores the caller's device itself, so no
``torch.cuda.device`` context is entered.  A build or launch error
raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import count_launch, load_library

# dynamic shared memory a block may take on an H100, less room for the
# kernel's static scratch
MAX_SHARED_BYTES = 227 * 1024 - 256
_CB = 16                        # classes a thread holds (kCB in the source)
_LABELS64 = {torch.int64: 1, torch.int32: 0}


@functools.cache
def _launcher():
    fn = load_library("persample_gradnorm.cu").psg_sigma_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _r4(n: int) -> int:
    return (n + 3) & ~3


@functools.lru_cache(maxsize=64)
def _plan(B: int, d: int, C: int) -> tuple[int, int]:
    """(kt, bytes): the columns of a feature tile and the block's dynamic
    shared memory, laid out as the kernel's step 1 lays it out (logits
    [B*C] + 4, E [B, C padded to 4] + 16, the tile [B, kt], two [B]
    rows).  kt is d when all of h fits, else the widest multiple of 4
    that does; raises ValueError when not even 4 columns fit."""
    fixed = _r4(B * C + 4) + B * _r4(C) + _CB + 2 * B
    room = MAX_SHARED_BYTES // 4 - fixed
    kt = d if _r4(B * d) <= room else max(0, room // B) // 4 * 4
    if kt < min(d, 4):
        raise ValueError(f"batch {B} x {C} classes does not fit the "
                         f"kernel's shared memory")
    return kt, 4 * (fixed + _r4(B * kt))


def _check(features, logits, labels):
    """(V, B, d, C, labels64, kt, smem, device index) of valid inputs;
    else raises ValueError."""
    device = None
    for x in (features, logits, labels):
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            raise ValueError("persample_gradnorm_cuda takes CUDA tensors "
                             "only")
        if device is None:
            device = x.get_device()
        if not x.is_contiguous() or x.get_device() != device:
            raise ValueError("persample_gradnorm_cuda takes contiguous "
                             "tensors on one device")
    labels64 = _LABELS64.get(labels.dtype)
    if features.dtype != torch.float32 or logits.dtype != torch.float32 \
            or labels64 is None:
        raise ValueError(f"persample_gradnorm_cuda takes f32 features and "
                         f"logits and int32 or int64 labels, got "
                         f"{features.dtype}, {logits.dtype}, {labels.dtype}")
    if features.dim() != 3 or logits.dim() != 3 or labels.dim() != 2:
        raise ValueError("expected features [V,B,d], logits [V,B,C], "
                         "labels [V,B]")
    V, B, d = features.shape
    C = logits.shape[2]
    if logits.shape[:2] != (V, B) or labels.shape != (V, B):
        raise ValueError(f"shape mismatch: features {tuple(features.shape)}"
                         f", logits {tuple(logits.shape)}, labels "
                         f"{tuple(labels.shape)}")
    if B == 0:
        raise ValueError("persample_gradnorm_cuda needs a batch of at "
                         "least one sample")
    return (V, B, d, C, labels64, *_plan(B, d, C), device)


def persample_gradnorm_cuda_batched(features, logits, labels):
    """features [V,B,d] f32, logits [V,B,C] f32, labels [V,B] int64 or
    int32 (CUDA) -> (sigma [V] f32, gi_sq [V,B] f32)."""
    V, B, d, C, labels64, kt, smem, device = _check(features, logits,
                                                    labels)
    gi_sq = features.new_empty((V, B))
    sigma = features.new_empty((V,))
    if V == 0:
        return sigma, gi_sq
    err = _launcher()(features.data_ptr(), logits.data_ptr(),
                      labels.data_ptr(), gi_sq.data_ptr(), sigma.data_ptr(),
                      V, B, d, C, labels64, kt, smem, device,
                      torch._C._cuda_getCurrentRawStream(device))
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
