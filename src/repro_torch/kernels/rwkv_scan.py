"""RWKV6 WKV recurrence kernel and its backward (CUDA C++, sm_90a).

Replaces ``repro/kernels/rwkv_scan.py:wkv_pallas``.  The kernel is
``csrc/wkv.cu``, a chunked scan (its header says how it is laid out and
what bounds it); the backward is ``csrc/wkv_bwd.cu`` (K5-bwd: the JAX
package differentiates its plain scan instead).  Both are built with
``nvcc`` on first use and called through ``ctypes``.  Unlike the Pallas
kernel the forward takes an initial state, as the model's
``wkv_chunked`` does.

  * ``wkv_cuda`` r, k, v, w [B, T, H, hd] f32, u [H, hd] f32, state
    [B, H, hd, hd] f32 -> (y [B, T, H, hd] f32, final state f32); with
    ``save_chunks`` also the state entering each chunk of 16 steps,
    [B, ceil(T / 16), H, hd, hd] f32, for the backward.
  * ``wkv_bwd_cuda`` r, k, v, w, u, those chunk states, dy [B, T, H, hd]
    and the final state's gradient [B, H, hd, hd] -> (dr, dk, dv, dw, du,
    d state), f32: two launches (the scan, then du's sum over the batch
    in a fixed order), counted once as ``wkv_bwd``.

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
CHUNK = 16                      # steps between the saved chunk states


@functools.cache
def _launcher():
    fn = load_library("wkv.cu").wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    fn = load_library("wkv_bwd.cu").wkv_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 \
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


def wkv_cuda(r, k, v, w, u, state, save_chunks=False):
    B, T, H, hd, device = _check(r, k, v, w, u, state)
    y = r.new_empty(r.shape)
    s_out = state.new_empty(state.shape)
    chunks = (r.new_empty((B, -(-T // CHUNK), H, hd, hd)) if save_chunks
              else None)
    if B * H > 0:
        err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          w.data_ptr(), u.data_ptr(), state.data_ptr(),
                          y.data_ptr(), s_out.data_ptr(),
                          chunks.data_ptr() if save_chunks else None, B, T,
                          H, hd, device,
                          torch._C._cuda_getCurrentRawStream(device))
        if err != 0:
            raise RuntimeError(f"wkv launch failed: cudaError {err}")
        count_launch("wkv", r.shape)
    return (y, s_out, chunks) if save_chunks else (y, s_out)


def wkv_bwd_cuda(r, k, v, w, u, chunks, dy, dstate):
    """Gradients of ``wkv_cuda``'s (y, final state) for dy and dstate,
    from the forward's chunk states -> (dr, dk, dv, dw, du, dstate0).
    dy is staged by 16-byte copies and the chunk states read by 8-byte
    loads: either off that alignment is copied first."""
    B, T, H, hd, device = _check(r, k, v, w, u, dstate)
    for x, shape in ((chunks, (B, -(-T // CHUNK), H, hd, hd)),
                     (dy, tuple(r.shape))):
        if not (x.is_cuda and x.dtype == torch.float32
                and x.is_contiguous() and tuple(x.shape) == shape
                and x.get_device() == device):
            raise ValueError(f"wkv_bwd_cuda takes contiguous f32 chunk "
                             f"states {shape} and dy like r on r's device")
    if dy.data_ptr() % 16:      # staged by 16-byte copies, as r, k, v, w
        dy = dy.clone()
    if chunks.data_ptr() % 8:   # read by 8-byte loads
        chunks = chunks.clone()
    grads = [r.new_empty(r.shape) for _ in range(4)]
    du = u.new_zeros(u.shape)
    ds0 = dstate.new_empty(dstate.shape)
    if B * H == 0:
        return (*grads, du, ds0)
    du_part = r.new_empty((B, H, hd))
    err = _bwd_launcher()(
        *(x.data_ptr() for x in (r, k, v, w, u, chunks, dy, dstate, *grads,
                                 du_part, du, ds0)),
        B, T, H, hd, device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"wkv_bwd launch failed: cudaError {err}")
    count_launch("wkv_bwd", r.shape)
    return (*grads, du, ds0)
