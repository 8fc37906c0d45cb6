"""RWKV6 WKV recurrence kernel (CUDA C++, sm_90a).

Replaces ``repro/kernels/rwkv_scan.py:wkv_pallas``.  The kernel is
``csrc/wkv.cu`` (its header says how it is laid out and what bounds
it); it is built with ``nvcc`` on first use and called through
``ctypes``.  Unlike the Pallas kernel it takes an initial state, as the
model's ``wkv_chunked`` does.

  * ``wkv_cuda`` r, k, v, w [B, T, H, hd] f32, u [H, hd] f32, state
    [B, H, hd, hd] f32 -> (y [B, T, H, hd] f32, final state f32).
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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def wkv_cuda(r, k, v, w, u, state):
    xs = (r, k, v, w, u, state)
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in xs):
        raise ValueError("wkv_cuda takes CUDA tensors only")
    if r.dim() != 4 or any(tuple(x.shape) != tuple(r.shape)
                           for x in (k, v, w)):
        raise ValueError("expected r, k, v, w of one shape [B,T,H,hd]")
    B, T, H, hd = r.shape
    if tuple(u.shape) != (H, hd) or tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"expected u [H,hd] and state [B,H,hd,hd], got "
                         f"{tuple(u.shape)}, {tuple(state.shape)}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"wkv kernel takes head sizes {HEAD_SIZES}, "
                         f"not {hd}")
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in xs):
        raise ValueError("wkv_cuda takes contiguous f32 tensors")
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    if B * H == 0:
        return y, s_out
    launch = _launcher()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = launch(*(x.data_ptr() for x in xs), y.data_ptr(),
                     s_out.data_ptr(), B, T, H, hd, stream)
    if err != 0:
        raise RuntimeError(f"wkv launch failed: cudaError {err}")
    count_launch("wkv", r.shape)
    return y, s_out
