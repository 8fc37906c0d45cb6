"""Batched WEMD add row and swap matrix kernels (CUDA C++, sm_90a).

Replace the Pallas TPU kernels of ``repro/kernels/wemd_swap.py``:

  * ``wemd_add_cuda``  <- ``wemd_add_pallas``: the GS add row [B, V]
  * ``wemd_swap_cuda`` <- ``wemd_swap_pallas``: the FSCD swap matrix
    [B, V, V]

Both kernels are in ``csrc/wemd.cu`` (its header says how they are laid
out and what bounds them), built with ``nvcc`` on first use and called
through ``ctypes``.  The inputs are all f32 or all f64, as the scheduler
keeps them: the kernels round f64 to f32 as they load it, so the f64
call gives the f32 call's bits on the cast inputs and no cast kernel
runs in front of it.

A call's time is its host launch path (the kernels take about the ~2 us
floor of any launch), so the path is short: one validation pass, one
``torch.empty``, the current stream's raw handle, one ``ctypes`` call
whose ``argtypes`` were set once.  The C launcher makes the tensors'
device current for the launch and restores the caller's device itself,
so no ``torch.cuda.device`` context is entered.  A build or launch error
raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import count_launch, load_library

_DTYPE_FLAG = {torch.float32: 0, torch.float64: 1}


@functools.cache
def _launchers():
    """(wemd_add_launch, wemd_swap_launch) of ``csrc/wemd.cu``."""
    lib = load_library("wemd.cu")
    fns = (lib.wemd_add_launch, lib.wemd_swap_launch)
    for fn in fns:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _check(p_sum, p_dev, global_dist, class_weights, sizes):
    """(B, V, C, dtype flag, device index) of valid inputs; else raises
    ValueError.  One pass over the five tensors: a call's time is its
    host path."""
    args = (p_dev, p_sum, global_dist, class_weights, sizes)
    device = None
    for x in args:                  # p_dev first: its dtype and device rule
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            raise ValueError("the WEMD kernels take CUDA tensors only")
        if device is None:
            dtype, device = x.dtype, x.get_device()
        if x.dtype != dtype or not x.is_contiguous() \
                or x.get_device() != device:
            raise ValueError("the WEMD kernels take contiguous tensors of "
                             "one dtype on one device, got "
                             f"{[(x.dtype, x.device) for x in args]}")
    flag = _DTYPE_FLAG.get(dtype)
    if flag is None:
        raise ValueError(f"the WEMD kernels take f32 or f64, got {dtype}")
    if p_dev.dim() != 3:
        raise ValueError(f"p_dev must be [B, V, C], got {tuple(p_dev.shape)}")
    B, V, C = p_dev.shape
    if not (p_sum.shape == global_dist.shape == class_weights.shape
            == (B, C) and sizes.shape == (B,)):
        raise ValueError(f"with p_dev {(B, V, C)}: p_sum, global_dist, "
                         f"class_weights must be {(B, C)} and sizes {(B,)}, "
                         f"got {[tuple(x.shape) for x in args]}")
    return B, V, C, flag, device


def _launch(which, name, out, p_sum, p_dev, gd, cw, sizes, B, V, C, flag,
            device):
    err = _launchers()[which](
        p_sum.data_ptr(), p_dev.data_ptr(), gd.data_ptr(), cw.data_ptr(),
        sizes.data_ptr(), out.data_ptr(), B, V, C, flag, device,
        torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    count_launch(name, p_dev.shape)


def wemd_add_cuda(p_sum, p_dev, global_dist, class_weights, sizes):
    """[B, V] f32 add row (sizes >= 0)."""
    B, V, C, flag, device = _check(p_sum, p_dev, global_dist,
                                   class_weights, sizes)
    out = p_dev.new_empty((B, V), dtype=torch.float32)
    if B and V:
        _launch(0, "wemd_add", out, p_sum, p_dev, global_dist,
                class_weights, sizes, B, V, C, flag, device)
    return out


def wemd_swap_cuda(p_sum, p_dev, global_dist, class_weights, sizes):
    """Dense [B, V, V] f32 swap matrix (sizes >= 1)."""
    B, V, C, flag, device = _check(p_sum, p_dev, global_dist,
                                   class_weights, sizes)
    out = p_dev.new_empty((B, V, V), dtype=torch.float32)
    if B and V:
        _launch(1, "wemd_swap", out, p_sum, p_dev, global_dist,
                class_weights, sizes, B, V, C, flag, device)
    return out
