"""Causal / sliding-window attention kernel (CUDA C++, sm_90a).

Replaces ``repro/kernels/flash_attention.py:flash_attention``.  The
kernel is ``csrc/flash_attention.cu`` (its header says how it is laid
out and what bounds it); it is built with ``nvcc`` on first use and
called through ``ctypes``.  The dtype picks its route: bf16 runs on the
tensor cores (``wgmma``, P split into bf16 hi + lo), f32 on the CUDA
cores.

  * ``flash_attention_cuda`` q [B, H, S, hd], k/v [B, KV, T, hd] (KV
    divides H; f32 or bf16, all one dtype) -> [B, H, S, hd] in q's dtype.

The tensors may be strided views (only the last axis must be
contiguous): the model passes its [B, S, H, hd] projections transposed,
and gets back a [B, H, S, hd] view of [B, S, H, hd] memory.  The bf16
route copies rows in 16-byte pieces, so there the data must be 16-byte
aligned and every stride a multiple of 8 elements.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.common import count_launch, load_library

HEAD_SIZES = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = load_library("flash_attention.cu").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in (q, k, v)):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError("expected q [B,H,S,hd] and k, v [B,KV,T,hd]")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if B * H > 65535:
        raise ValueError(f"batch x heads {B * H} exceeds the launch grid")
    if hd not in HEAD_SIZES:
        raise ValueError(f"attention kernel takes head sizes {HEAD_SIZES}, "
                         f"not {hd}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes f32 or bf16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("attention kernel needs a contiguous last axis")
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 or any(x.stride(i) % 8 for i in range(3)
                                     if x.shape[i] > 1) for x in (q, k, v)):
        raise ValueError("bf16 attention kernel needs 16-byte aligned q, k, "
                         "v with strides in multiples of 8 elements")
    out = torch.empty((B, S, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B * H * S == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, H, KV, S, T, hd, DTYPES[q.dtype],
                     *(x.stride(i) for x in (q, k, v, out) for i in range(3)),
                     int(causal), int(window), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"attention launch failed: cudaError {err}")
    count_launch("attention", q.shape, k.shape, (int(causal), int(window)))
    return out
