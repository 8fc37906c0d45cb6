"""Causal / sliding-window attention kernel (CUDA C++, sm_90a).

Replaces ``repro/kernels/flash_attention.py:flash_attention``.  The
kernel is ``csrc/flash_attention.cu`` (its header says how it is laid
out and what bounds it); it is built with ``nvcc`` on first use and
called through ``ctypes``.  The dtype picks its route: bf16 runs on the
tensor cores (``wgmma``, P split into bf16 hi + lo), f32 on the CUDA
cores.

  * ``flash_attention_cuda`` q [B, H, S, hd], k [B, KV, T, hd], v [B, KV,
    T, hdv] (KV divides H; f32 or bf16, all one dtype) -> [B, H, S, hdv]
    in q's dtype.  hdv = hd in ``HEAD_SIZES``, or (hd, hdv) in
    ``HEAD_PAIRS``: (192, 128), latent attention's q/k [nope 128 | rope
    64] and v 128 (moonlight-16b-a3b).  The scale is 1/sqrt(hd) unless
    given.
  * ``flash_attention_bwd_cuda`` its backward (``csrc/flash_attention_bwd.cu``;
    the JAX package has none, it differentiates its plain attention): q,
    k, v and dO -> (dq, dk, dv) in the inputs' dtype, summed in f32, the
    GQA sum over a key head's query heads in a fixed order, without
    atomics.  Two routes as the forward's: bf16 on the tensor cores (P
    and dS split into bf16 hi + lo; the GQA sum spread over ``parts``
    blocks a key head, ``gqa_parts``), f32 on the CUDA cores.

The tensors may be strided views (only the last axis must be
contiguous): the model passes its [B, S, H, hd] projections transposed,
and gets back a [B, H, S, hd] view of [B, S, H, hd] memory.  The bf16
route copies rows in 16-byte pieces, so there the data must be 16-byte
aligned and every stride a multiple of 8 elements (``tc_aligned``); it
raises ``ValueError`` otherwise and never takes the CUDA-core route.

The launch path is short: one validation pass, the outputs' allocation,
the current stream's raw handle, one ``ctypes`` call whose ``argtypes``
were set once; the C launcher makes the tensors' device current and
restores the caller's, so no ``torch.cuda.device`` context is entered.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.common import count_launch, load_library

HEAD_SIZES = (32, 64, 128, 256)
HEAD_PAIRS = ((192, 128),)       # (q and k, v) head sizes where they differ
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launcher():
    fn = load_library("flash_attention.cu").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    fn = load_library("flash_attention_bwd.cu").flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, name):
    """(B, H, KV, S, T, hd, hdv) of valid inputs; else raises
    ValueError."""
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in (q, k, v)):
        raise ValueError(f"{name} takes CUDA tensors only")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError("expected q [B,H,S,hd], k [B,KV,T,hd] and v "
                         "[B,KV,T,hdv]")
    B, H, S, hd = q.shape
    KV, T, hdv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if B * H > 65535:
        raise ValueError(f"batch x heads {B * H} exceeds the launch grid")
    if not (hd == hdv and hd in HEAD_SIZES) and (hd, hdv) not in HEAD_PAIRS:
        raise ValueError(f"attention kernel takes head sizes {HEAD_SIZES} "
                         f"for q, k and v, or (q/k, v) pairs {HEAD_PAIRS}, "
                         f"not ({hd}, {hdv})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes f32 or bf16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("attention kernel needs a contiguous last axis")
    return B, H, KV, S, T, hd, hdv


def tc_aligned(x: torch.Tensor) -> bool:
    """Whether the tensor-core route can copy ``x``'s rows in 16-byte
    pieces: 16-byte aligned data, batch, head and row strides in
    multiples of 8 elements (a stride of a size-1 axis is never used)."""
    return x.data_ptr() % 16 == 0 and not any(
        x.stride(i) % 8 for i in range(3) if x.shape[i] > 1)


def _require_tc_aligned(xs, names):
    if not all(tc_aligned(x) for x in xs):
        raise ValueError(f"bf16 attention kernel needs 16-byte aligned "
                         f"{names} with strides in multiples of 8 elements")


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gqa_parts(B: int, KV: int, T: int, group: int, sms: int) -> int:
    """Parts the bf16 dk/dv pass splits a key head's group of ``group``
    query heads into: the fewest (a divisor of the group) that give two
    blocks an SM over the 64-key tiles, else the whole group (a block a
    query head).  One part sums the group inside a block; more write f32
    partial sums that a third launch adds in order."""
    blocks = -(-T // 64) * B * KV
    for parts in range(1, group + 1):
        if group % parts == 0 and blocks * parts >= 2 * sms:
            return parts
    return group


def _mask_key(causal, window, q_offset, S, T):
    """The launch counters' mask key: (causal, window), and the query
    offset where it is not the default T - S."""
    key = (int(causal), int(window))
    return key if q_offset == T - S else key + (int(q_offset),)


def _counted_shapes(q, k, v, key):
    """The shapes a launch is counted at: q's, k's and the mask key, and
    v's where its head size is not k's."""
    shapes = (q.shape, k.shape, key)
    return shapes if v.shape[3] == k.shape[3] else shapes + (v.shape,)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int | None = None,
                         scale: float | None = None):
    """``q_offset``: the key position of query 0 (the causal edge is k <=
    q + q_offset); T - S by default, queries right-aligned.  ``scale``:
    1/sqrt(hd) by default."""
    B, H, KV, S, T, hd, hdv = _check(q, k, v, "flash_attention_cuda")
    q_offset = T - S if q_offset is None else int(q_offset)
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    if q.dtype == torch.bfloat16:
        _require_tc_aligned((q, k, v), "q, k, v")
    out = torch.empty((B, S, H, hdv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B * H * S == 0:
        return out
    device = q.get_device()
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, H, KV, S, T, hd, hdv,
                      DTYPES[q.dtype],
                      *(x.stride(i) for x in (q, k, v, out) for i in range(3)),
                      int(causal), int(window), q_offset, scale, device,
                      torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"attention launch failed: cudaError {err}")
    count_launch("attention", *_counted_shapes(
        q, k, v, _mask_key(causal, window, q_offset, S, T)))
    return out


def flash_attention_bwd_cuda(q, k, v, do, *, causal: bool = True,
                             window: int = 0, parts: int | None = None,
                             q_offset: int | None = None,
                             scale: float | None = None):
    """Gradients of ``flash_attention_cuda(q, k, v, q_offset=...,
    scale=...)`` for the output's gradient ``do`` [B, H, S, hdv] -> (dq,
    dk, dv) in the inputs' dtype (each strided as its input, when that is
    dense).  ``parts`` (bf16 only, a divisor of H / KV; 1 at a head pair)
    overrides ``gqa_parts``'s choice."""
    B, H, KV, S, T, hd, hdv = _check(q, k, v, "flash_attention_bwd_cuda")
    q_offset = T - S if q_offset is None else int(q_offset)
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    if not (isinstance(do, torch.Tensor) and do.is_cuda) \
            or tuple(do.shape) != (B, H, S, hdv) or do.dtype != q.dtype \
            or do.stride(3) != 1 or do.device != q.device:
        raise ValueError("flash_attention_bwd_cuda needs do of the "
                         "output's shape, q's dtype and device, with a "
                         "contiguous last axis")
    if causal and q_offset < 0:
        raise ValueError(f"attention backward: with causal and query "
                         f"offset {q_offset} (T {T}, S {S}) the first rows "
                         f"see no key")
    device = q.get_device()
    group = H // KV
    if q.dtype == torch.bfloat16:
        _require_tc_aligned((q, k, v, do), "q, k, v, do")
        if parts is None:
            parts = (gqa_parts(B, KV, T, group, _sm_count(device))
                     if hd == hdv else 1)
    if parts is None:
        parts = 1
    if parts < 1 or group % parts or (parts > 1 and (
            q.dtype != torch.bfloat16 or hd != hdv)):
        raise ValueError(f"attention backward: {parts} parts of a group of "
                         f"{group} (bf16 and one head size only)")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if B * H * S * T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty(3 * B * H * S, dtype=torch.float32, device=q.device)
    partial = (torch.empty(2 * parts * B * KV * T * hd, dtype=torch.float32,
                           device=q.device) if parts > 1 else None)
    strides = (ctypes.c_longlong * 21)(*(
        x.stride(i) for x in (q, k, v, do, dq, dk, dv) for i in range(3)))
    err = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        None if partial is None else partial.data_ptr(), B, H, KV, S, T, hd,
        hdv, DTYPES[q.dtype], parts, strides, int(causal), int(window),
        q_offset, scale, device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"attention backward launch failed: cudaError "
                           f"{err}")
    count_launch("attention_bwd", *_counted_shapes(
        q, k, v, _mask_key(causal, window, q_offset, S, T)))
    return dq, dk, dv
