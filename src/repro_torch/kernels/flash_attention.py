"""Causal / sliding-window attention kernel (CUDA C++, sm_90a).

Replaces ``repro/kernels/flash_attention.py:flash_attention``.  The
kernel is ``csrc/flash_attention.cu`` (its header says how it is laid
out and what bounds it); it is built with ``nvcc`` on first use and
called through ``ctypes``.  The dtype picks its route: bf16 runs on the
tensor cores (``wgmma``, P split into bf16 hi + lo), f32 on the CUDA
cores.

  * ``flash_attention_cuda`` q [B, H, S, hd], k/v [B, KV, T, hd] (KV
    divides H; f32 or bf16, all one dtype) -> [B, H, S, hd] in q's dtype.
  * ``flash_attention_bwd_cuda`` its backward (``csrc/flash_attention_bwd.cu``,
    on the CUDA cores; the JAX package has none, it differentiates its
    plain attention): q, k, v and dO -> (dq, dk, dv) in the inputs'
    dtype, summed in f32; the GQA sum over a key head's query heads in a
    fixed order, without atomics.

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


@functools.cache
def _bwd_launcher():
    fn = load_library("flash_attention_bwd.cu").flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p] + [ctypes.c_int] * 2 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, name):
    """(B, H, KV, S, T, hd) of valid inputs; else raises ValueError."""
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in (q, k, v)):
        raise ValueError(f"{name} takes CUDA tensors only")
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
    return B, H, KV, S, T, hd


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    B, H, KV, S, T, hd = _check(q, k, v, "flash_attention_cuda")
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


def flash_attention_bwd_cuda(q, k, v, do, *, causal: bool = True,
                             window: int = 0):
    """Gradients of ``flash_attention_cuda(q, k, v)`` for the output's
    gradient ``do`` [B, H, S, hd] -> (dq, dk, dv) in the inputs' dtype
    (each strided as its input, when that is dense)."""
    B, H, KV, S, T, hd = _check(q, k, v, "flash_attention_bwd_cuda")
    if not (isinstance(do, torch.Tensor) and do.is_cuda) \
            or do.shape != q.shape or do.dtype != q.dtype \
            or do.stride(3) != 1 or do.device != q.device:
        raise ValueError("flash_attention_bwd_cuda needs do of q's shape, "
                         "dtype and device, with a contiguous last axis")
    if causal and T < S:
        raise ValueError(f"attention backward: with causal and T {T} < S "
                         f"{S} the first rows see no key")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if B * H * S * T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty(3 * B * H * S, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 21)(*(
        x.stride(i) for x in (q, k, v, do, dq, dk, dv) for i in range(3)))
    device = q.get_device()
    err = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        B, H, KV, S, T, hd, DTYPES[q.dtype], strides, int(causal),
        int(window), 1.0 / math.sqrt(hd), device,
        torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"attention backward launch failed: cudaError "
                           f"{err}")
    count_launch("attention_bwd", q.shape, k.shape,
                 (int(causal), int(window)))
    return dq, dk, dv
