"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py``; any other device raises.  There is no fallback:
a kernel that fails to build or launch raises.  Inputs are cast to f32
here, exactly as the Pallas wrappers of ``repro.kernels`` cast them, so
both routes compute the same f32 function; two exceptions.  Attention
takes bf16 as it comes, as the Pallas kernel does, and sums in f32 (its
kernel's bf16 route multiplies on the tensor cores, to one bf16 step of
the f32 function).  The WEMD kernels take the scheduler's f64 state as it
comes and round it to f32 as they load it, the rounding of the cast, so
no cast kernel is launched in front of them; the Eq. 10 kernel reads
int64 labels (the round's) as they come.

Gradients.  On the CPU the plain versions run under autograd.  On the
card, ``attention``, ``rglru`` and ``wkv`` go through
``torch.autograd.Function``s whose backward is a hand-written kernel
(``AttentionFn``, ``RGLRUFn``, ``WKVFn``); the FL kernels have no
backward kernel, so they raise when a gradient is asked of them rather
than return outputs that autograd would treat as constants.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import persample_gradnorm as psg
from repro_torch.kernels import ref
from repro_torch.kernels.wemd_swap import wemd_add_cuda, wemd_swap_cuda


def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _refuse_grad(name: str, *xs) -> None:
    """Raise where autograd would need a backward the card lacks."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        raise NotImplementedError(
            f"{name} has no backward kernel on the card, and its "
            f"kernel's outputs carry no gradient; call it under "
            f"torch.no_grad() or on CPU tensors")


class AttentionFn(torch.autograd.Function):
    """The attention kernel with its backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.flash_attention import (
            flash_attention_bwd_cuda, tc_aligned)
        q, k, v = ctx.saved_tensors
        causal, window = ctx.mask
        # the kernel reads a contiguous last axis, and on the bf16 route
        # rows in 16-byte pieces: a dense copy of any other dO
        if do.stride(3) != 1 or (do.dtype == torch.bfloat16
                                 and not tc_aligned(do)):
            do = do.clone(memory_format=torch.contiguous_format)
        return (*flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                          window=window), None, None)


class RGLRUFn(torch.autograd.Function):
    """The RG-LRU scan with its backward kernel (a reverse scan that
    reads the forward's h)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        from repro_torch.kernels.rglru_scan import rglru_cuda
        h, h_last = rglru_cuda(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        from repro_torch.kernels.rglru_scan import rglru_bwd_cuda
        a, h, h0 = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.contiguous()
        dh_last = (torch.zeros_like(h0) if dh_last is None
                   else dh_last.contiguous())
        return rglru_bwd_cuda(a, h, h0, dh, dh_last)


class WKVFn(torch.autograd.Function):
    """The WKV scan with its backward kernel: the forward saves the state
    entering each chunk of 16 steps, from which the backward recomputes
    each chunk's steps."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        from repro_torch.kernels.rwkv_scan import wkv_cuda
        y, s, chunks = wkv_cuda(r, k, v, w, u, state, save_chunks=True)
        ctx.save_for_backward(r, k, v, w, u, chunks)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda
        r, k, v, w, u, chunks = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        B, _, H, hd = r.shape
        ds = (r.new_zeros((B, H, hd, hd)) if ds is None
              else ds.contiguous())
        return wkv_bwd_cuda(r, k, v, w, u, chunks, dy, ds)


def _f32(*xs):
    """xs as contiguous f32: each x itself (no kernel, the least host
    work) where it already is one."""
    return [x if x.dtype == torch.float32 and x.is_contiguous()
            else x.to(torch.float32).contiguous() for x in xs]


def _wemd_cuda_args(xs):
    """The WEMD kernels' inputs on CUDA: f32 or f64 of one dtype as they
    come (``contiguous`` launches nothing on contiguous input), any other
    dtype cast to f32."""
    dtype = xs[1].dtype
    if dtype in (torch.float32, torch.float64) \
            and all(x.dtype == dtype for x in xs):
        return [x.contiguous() for x in xs]
    return _f32(*xs)


def wemd_swap(p_sum, p_dev, global_dist, class_weights, sizes):
    """Dense [B,V,V] swap-candidate WEMD matrix (FSCD inner loop)."""
    args = (p_sum, p_dev, global_dist, class_weights, sizes)
    if _route(p_dev) == "cuda":
        _refuse_grad("wemd_swap", *args)
        return wemd_swap_cuda(*_wemd_cuda_args(args))
    return ref.wemd_swap_ref(*_f32(*args))


def wemd_add(p_sum, p_dev, global_dist, class_weights, sizes):
    """[B,V] add-candidate WEMD row (GS inner loop)."""
    args = (p_sum, p_dev, global_dist, class_weights, sizes)
    if _route(p_dev) == "cuda":
        _refuse_grad("wemd_add", *args)
        return wemd_add_cuda(*_wemd_cuda_args(args))
    return ref.wemd_add_ref(*_f32(*args))


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,H,S,hd], k/v [B,KV,T,hd] (KV divides H; strided views
    allowed) -> [B,H,S,hd] in q's dtype; differentiable on both routes."""
    if _route(q) == "cuda":
        return AttentionFn.apply(q, k, v, causal, window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


def wkv(r, k, v, w, u, state):
    """RWKV6 WKV over r, k, v, w [B,T,H,hd] from state [B,H,hd,hd] ->
    (y [B,T,H,hd] in r's dtype, final state f32); differentiable on both
    routes.  On the card the chunk states are saved only when a gradient
    is being recorded."""
    args = _f32(r, k, v, w, u, state)
    if _route(r) == "cuda":
        if torch.is_grad_enabled() and any(x.requires_grad for x in args):
            y, s = WKVFn.apply(*args)
        else:
            from repro_torch.kernels.rwkv_scan import wkv_cuda
            y, s = wkv_cuda(*args)
    else:
        y, s = ref.wkv_ref(*args)
    return y.to(r.dtype), s


def rglru(a, b, h0):
    """h_t = a_t h_{t-1} + b_t: a, b [B,T,D], h0 [B,D] -> (h [B,T,D],
    h_T [B,D]), f32; differentiable on both routes."""
    args = _f32(a, b, h0)
    if _route(a) == "cuda":
        return RGLRUFn.apply(*args)
    return ref.rglru_ref(*args)


def persample_gradnorm(features, logits, labels):
    """Eq. 10 for a softmax-CE head: features [..., B, d] with at most
    one leading device axis -> (sigma [...], gi_sq [..., B])."""
    if _route(features) == "cuda":
        _refuse_grad("persample_gradnorm", features, logits)
        h, lg = _f32(features, logits)
        if labels.dtype not in (torch.int64, torch.int32):
            labels = labels.long()
        fn = (psg.persample_gradnorm_cuda if h.dim() == 2
              else psg.persample_gradnorm_cuda_batched)
        return fn(h, lg, labels.contiguous())
    return ref.persample_gradnorm_ref(features, logits, labels)


def persample_gradnorm_sigma(features, logits, labels):
    return persample_gradnorm(features, logits, labels)[0]
