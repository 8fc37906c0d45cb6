"""RWKV6 WKV recurrence kernel (CUDA C++, sm_90a).

Replaces ``repro/kernels/rwkv_scan.py:wkv_pallas``.  The kernel is
``csrc/wkv.cu``, a chunked scan (its header says how it is laid out and
what bounds it); it is built with ``nvcc`` on first use and called
through ``ctypes``.  Unlike the Pallas kernel it takes an initial state,
as the model's ``wkv_chunked`` does.

  * ``wkv_cuda`` r, k, v, w [B, T, H, hd] f32, u [H, hd] f32, state
    [B, H, hd, hd] f32 -> (y [B, T, H, hd] f32, final state f32).

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

HEAD_SIZES = (16, 32, 64, 128)


@functools.cache
def _launcher():
    fn = load_library("wkv.cu").wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, state):
    """(B, T, H, hd, device index) of valid inputs; else raises
    ValueError.  r, k, v and w are staged by 16-byte copies, so they must
    be 16-byte aligned."""
    device = None
    for i, x in enumerate((r, k, v, w, u, state)):
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            raise ValueError("wkv_cuda takes CUDA tensors only")
        if device is None:
            device = x.get_device()
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or x.get_device() != device or (i < 4 and x.data_ptr() % 16):
            raise ValueError("wkv_cuda takes contiguous f32 tensors on one "
                             "device, r, k, v, w 16-byte aligned")
    if r.dim() != 4 or not (k.shape == v.shape == w.shape == r.shape):
        raise ValueError("expected r, k, v, w of one shape [B,T,H,hd]")
    B, T, H, hd = r.shape
    if u.shape != (H, hd) or state.shape != (B, H, hd, hd):
        raise ValueError(f"expected u [H,hd] and state [B,H,hd,hd], got "
                         f"{tuple(u.shape)}, {tuple(state.shape)}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"wkv kernel takes head sizes {HEAD_SIZES}, "
                         f"not {hd}")
    return B, T, H, hd, device


def wkv_cuda(r, k, v, w, u, state):
    B, T, H, hd, device = _check(r, k, v, w, u, state)
    y = r.new_empty(r.shape)
    s_out = state.new_empty(state.shape)
    if B * H == 0:
        return y, s_out
    err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), state.data_ptr(), y.data_ptr(),
                      s_out.data_ptr(), B, T, H, hd, device,
                      torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"wkv launch failed: cudaError {err}")
    count_launch("wkv", r.shape)
    return y, s_out
