"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py``; any other device raises.  There is no fallback:
a kernel that fails to build or launch raises.  Inputs are cast to f32
here, exactly as the Pallas wrappers of ``repro.kernels`` cast them, so
both routes compute the same f32 function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref


def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _f32(*xs):
    return [x.to(torch.float32).contiguous() for x in xs]


def wemd_swap(p_sum, p_dev, global_dist, class_weights, sizes):
    """Dense [B,V,V] swap-candidate WEMD matrix (FSCD inner loop)."""
    args = _f32(p_sum, p_dev, global_dist, class_weights, sizes)
    if _route(p_dev) == "cuda":
        from repro_torch.kernels.wemd_swap import wemd_swap_triton
        return wemd_swap_triton(*args)
    return ref.wemd_swap_ref(*args)


def wemd_add(p_sum, p_dev, global_dist, class_weights, sizes):
    """[B,V] add-candidate WEMD row (GS inner loop)."""
    args = _f32(p_sum, p_dev, global_dist, class_weights, sizes)
    if _route(p_dev) == "cuda":
        from repro_torch.kernels.wemd_swap import wemd_add_triton
        return wemd_add_triton(*args)
    return ref.wemd_add_ref(*args)


def persample_gradnorm(features, logits, labels):
    """Eq. 10 for a softmax-CE head: features [..., B, d] with at most
    one leading device axis -> (sigma [...], gi_sq [..., B])."""
    if _route(features) == "cuda":
        from repro_torch.kernels import persample_gradnorm as P
        if features.dim() == 2:
            return P.persample_gradnorm_cuda(features, logits, labels)
        return P.persample_gradnorm_cuda_batched(features, logits, labels)
    return ref.persample_gradnorm_ref(features, logits, labels)


def persample_gradnorm_sigma(features, logits, labels):
    return persample_gradnorm(features, logits, labels)[0]
