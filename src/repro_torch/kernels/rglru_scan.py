"""RG-LRU diagonal recurrence kernel (CUDA C++, sm_90a).

Replaces ``repro/kernels/rglru_scan.py:rglru_pallas``.  The kernel is
``csrc/rglru_scan.cu``, a time-parallel scan (its header says how it is
laid out and what bounds it); it is built with ``nvcc`` on first use and
called through ``ctypes``.

  * ``rglru_cuda`` a, b [B, T, D] f32, h0 [B, D] f32 -> (h [B, T, D],
    h_T [B, D]), both f32.
  * ``rglru_bwd_cuda`` its backward (the JAX package has none: it
    differentiates its plain recurrence): a, h (the forward's output),
    dh [B, T, D], h0, dh_T [B, D] f32 -> (da, db [B, T, D], dh0 [B, D]),
    a reverse scan of the same layout in the same source.

The launch path is short: one validation pass, the outputs'
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


@functools.cache
def _launcher():
    fn = load_library("rglru_scan.cu").rglru_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    fn = load_library("rglru_scan.cu").rglru_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, b, h0):
    """(B, T, D, device index) of valid inputs; else raises ValueError."""
    device = None
    for x in (a, b, h0):
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            raise ValueError("rglru_cuda takes CUDA tensors only")
        if device is None:
            device = x.get_device()
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or x.get_device() != device:
            raise ValueError("rglru_cuda takes contiguous f32 tensors on "
                             "one device")
    if a.dim() != 3 or b.shape != a.shape \
            or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"expected a, b [B,T,D] and h0 [B,D], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    return (*a.shape, device)


def rglru_cuda(a, b, h0):
    """h_t = a_t h_{t-1} + b_t over t, per (batch, channel)."""
    B, T, D, device = _check(a, b, h0)
    y = a.new_empty(a.shape)
    if T == 0:
        return y, h0.clone()
    h_last = h0.new_empty(h0.shape)
    if B * D == 0:
        return y, h_last
    err = _launcher()(a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
                      h_last.data_ptr(), B, T, D, device,
                      torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"rglru launch failed: cudaError {err}")
    count_launch("rglru", a.shape)
    return y, h_last


def rglru_bwd_cuda(a, h, h0, dh, dh_last):
    """Gradients of ``rglru_cuda``'s (h, h_T) -> (da, db, dh0)."""
    B, T, D, device = _check(a, h, h0)
    _check(a, dh, dh_last)
    if T == 0:
        return a.new_empty(a.shape), a.new_empty(a.shape), dh_last.clone()
    da, db = a.new_empty(a.shape), a.new_empty(a.shape)
    dh0 = h0.new_empty(h0.shape)
    if B * D == 0:
        return da, db, dh0
    err = _bwd_launcher()(a.data_ptr(), h.data_ptr(), h0.data_ptr(),
                          dh.data_ptr(), dh_last.data_ptr(), da.data_ptr(),
                          db.data_ptr(), dh0.data_ptr(), B, T, D, device,
                          torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"rglru backward launch failed: cudaError {err}")
    count_launch("rglru_bwd", a.shape)
    return da, db, dh0
