"""RG-LRU diagonal recurrence kernel (CUDA C++, sm_90a).

Replaces ``repro/kernels/rglru_scan.py:rglru_pallas``.  The kernel is
``csrc/rglru_scan.cu`` (its header says how it is laid out and what
bounds it); it is built with ``nvcc`` on first use and called through
``ctypes``.

  * ``rglru_cuda`` a, b [B, T, D] f32, h0 [B, D] f32 -> (h [B, T, D],
    h_T [B, D]), both f32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import count_launch, load_library


@functools.cache
def _launcher():
    fn = load_library("rglru_scan.cu").rglru_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_cuda(a, b, h0):
    """h_t = a_t h_{t-1} + b_t over t, per (batch, channel)."""
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in (a, b, h0)):
        raise ValueError("rglru_cuda takes CUDA tensors only")
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape) \
            or tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"expected a, b [B,T,D] and h0 [B,D], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    if any(x.dtype != torch.float32 or not x.is_contiguous()
           for x in (a, b, h0)):
        raise ValueError("rglru_cuda takes contiguous f32 tensors")
    B, T, D = a.shape
    y = torch.empty_like(a)
    h_last = h0.clone()
    if B * D == 0 or T == 0:
        return y, h_last
    launch = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
                     h_last.data_ptr(), B, T, D, stream)
    if err != 0:
        raise RuntimeError(f"rglru launch failed: cudaError {err}")
    count_launch("rglru", a.shape)
    return y, h_last
