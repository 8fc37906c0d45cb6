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
        return wemd_swap_cuda(*_wemd_cuda_args(args))
    return ref.wemd_swap_ref(*_f32(*args))


def wemd_add(p_sum, p_dev, global_dist, class_weights, sizes):
    """[B,V] add-candidate WEMD row (GS inner loop)."""
    args = (p_sum, p_dev, global_dist, class_weights, sizes)
    if _route(p_dev) == "cuda":
        return wemd_add_cuda(*_wemd_cuda_args(args))
    return ref.wemd_add_ref(*_f32(*args))


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B,H,S,hd], k/v [B,KV,T,hd] (KV divides H; strided views
    allowed) -> [B,H,S,hd] in q's dtype."""
    if _route(q) == "cuda":
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


def wkv(r, k, v, w, u, state):
    """RWKV6 WKV over r, k, v, w [B,T,H,hd] from state [B,H,hd,hd] ->
    (y [B,T,H,hd] in r's dtype, final state f32)."""
    args = _f32(r, k, v, w, u, state)
    if _route(r) == "cuda":
        from repro_torch.kernels.rwkv_scan import wkv_cuda
        y, s = wkv_cuda(*args)
    else:
        y, s = ref.wkv_ref(*args)
    return y.to(r.dtype), s


def rglru(a, b, h0):
    """h_t = a_t h_{t-1} + b_t: a, b [B,T,D], h0 [B,D] -> (h [B,T,D],
    h_T [B,D]), f32."""
    args = _f32(a, b, h0)
    if _route(a) == "cuda":
        from repro_torch.kernels.rglru_scan import rglru_cuda
        return rglru_cuda(*args)
    return ref.rglru_ref(*args)


def persample_gradnorm(features, logits, labels):
    """Eq. 10 for a softmax-CE head: features [..., B, d] with at most
    one leading device axis -> (sigma [...], gi_sq [..., B])."""
    if _route(features) == "cuda":
        h, lg = _f32(features, logits)
        if labels.dtype not in (torch.int64, torch.int32):
            labels = labels.long()
        fn = (psg.persample_gradnorm_cuda if h.dim() == 2
              else psg.persample_gradnorm_cuda_batched)
        return fn(h, lg, labels.contiguous())
    return ref.persample_gradnorm_ref(features, logits, labels)


def persample_gradnorm_sigma(features, logits, labels):
    return persample_gradnorm(features, logits, labels)[0]
