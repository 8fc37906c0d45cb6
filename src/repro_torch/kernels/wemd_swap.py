"""Batched WEMD swap/add candidate kernels for Hopper, in Triton.

They replace the Pallas TPU kernels of ``repro/kernels/wemd_swap.py``:

  * ``wemd_swap`` <- ``wemd_swap_pallas`` (body ``_swap_kernel``): the
    FSCD swap matrix
        W[b, i, j] = sum_c cw_c * | (p_sum - p_dev_i + p_dev_j) / s - gd_c |
  * ``wemd_add``  <- ``wemd_add_pallas``  (body ``_add_kernel``): the GS
    add row
        W[b, v] = sum_c cw_c * | (p_sum + p_dev_v) / (s + 1) - gd_c |

What bounds them on an H100: each output element costs ~6 flops per
class and the inputs are tiny (C = 10 classes, V <= 64 devices), so at
the round's shapes both are far below either roofline — the time is the
launch.  The TPU kernels tiled the class axis by 128 and carried class
partials across sequential grid steps; here one program owns a whole
output tile and loops over the class axis itself (classes padded to a
power of two under a mask, padded classes get weight 0), so nothing is
carried between programs and the [V, V, C] intermediate only ever
exists as a register tile.  Inputs are cast to f32 by the caller exactly
as the Pallas wrappers cast them (``kernels/ops.py``); the output is the
dense f32 matrix, the Pallas kernels' contract.

``triton`` is imported, and the kernels compiled, on the first launch:
the module imports on hosts without it.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.common import count_launch

BLOCK_I = 16          # swap rows per program
BLOCK_J = 32          # swap columns per inner step
BLOCK_V = 64          # add-row entries per program
MAX_BLOCK_C = 16      # class tile (power of two)


@functools.cache
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def swap_kernel(psum_ptr, pdev_ptr, gd_ptr, cw_ptr, size_ptr, out_ptr,
                    V, C, BLOCK_I: tl.constexpr, BLOCK_J: tl.constexpr,
                    BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        ri = tl.program_id(1) * BLOCK_I + tl.arange(0, BLOCK_I)
        imask = ri < V
        s = tl.load(size_ptr + b)
        for j0 in range(0, V, BLOCK_J):
            rj = j0 + tl.arange(0, BLOCK_J)
            jmask = rj < V
            acc = tl.zeros((BLOCK_I, BLOCK_J), dtype=tl.float32)
            for c0 in range(0, C, BLOCK_C):
                cols = c0 + tl.arange(0, BLOCK_C)
                cmask = cols < C
                ps = tl.load(psum_ptr + b * C + cols, mask=cmask, other=0.0)
                gd = tl.load(gd_ptr + b * C + cols, mask=cmask, other=0.0)
                cw = tl.load(cw_ptr + b * C + cols, mask=cmask, other=0.0)
                pi = tl.load(pdev_ptr + (b * V + ri[:, None]) * C
                             + cols[None, :],
                             mask=imask[:, None] & cmask[None, :], other=0.0)
                pj = tl.load(pdev_ptr + (b * V + rj[:, None]) * C
                             + cols[None, :],
                             mask=jmask[:, None] & cmask[None, :], other=0.0)
                base = (ps[None, None, :] - pi[:, None, :]) + pj[None, :, :]
                acc += tl.sum(tl.abs(base / s - gd[None, None, :])
                              * cw[None, None, :], axis=2)
            tl.store(out_ptr + (b * V + ri[:, None]) * V + rj[None, :], acc,
                     mask=imask[:, None] & jmask[None, :])

    @triton.jit
    def add_kernel(psum_ptr, pdev_ptr, gd_ptr, cw_ptr, size_ptr, out_ptr,
                   V, C, BLOCK_V: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        rows = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
        rmask = rows < V
        s1 = tl.load(size_ptr + b) + 1.0
        acc = tl.zeros((BLOCK_V,), dtype=tl.float32)
        for c0 in range(0, C, BLOCK_C):
            cols = c0 + tl.arange(0, BLOCK_C)
            cmask = cols < C
            ps = tl.load(psum_ptr + b * C + cols, mask=cmask, other=0.0)
            gd = tl.load(gd_ptr + b * C + cols, mask=cmask, other=0.0)
            cw = tl.load(cw_ptr + b * C + cols, mask=cmask, other=0.0)
            pd = tl.load(pdev_ptr + (b * V + rows[:, None]) * C
                         + cols[None, :],
                         mask=rmask[:, None] & cmask[None, :], other=0.0)
            new = (ps[None, :] + pd) / s1
            acc += tl.sum(tl.abs(new - gd[None, :]) * cw[None, :], axis=1)
        tl.store(out_ptr + b * V + rows, acc, mask=rmask)

    return triton, swap_kernel, add_kernel


def _check(p_sum, p_dev, global_dist, class_weights, sizes):
    args = (p_sum, p_dev, global_dist, class_weights, sizes)
    if not all(isinstance(x, torch.Tensor) and x.is_cuda for x in args):
        raise ValueError("the Triton WEMD kernels take CUDA tensors only")
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in args):
        raise ValueError("the Triton WEMD kernels take contiguous f32 "
                         "tensors")
    if p_dev.dim() != 3:
        raise ValueError(f"p_dev must be [B, V, C], got {tuple(p_dev.shape)}")
    B, V, C = p_dev.shape
    for name, x, shape in (("p_sum", p_sum, (B, C)),
                           ("global_dist", global_dist, (B, C)),
                           ("class_weights", class_weights, (B, C)),
                           ("sizes", sizes, (B,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    return B, V, C


def _block_c(C: int) -> int:
    return min(MAX_BLOCK_C, 1 << max(C - 1, 0).bit_length())


def wemd_swap_triton(p_sum, p_dev, global_dist, class_weights, sizes):
    """Dense [B, V, V] f32 swap matrix (sizes >= 1)."""
    B, V, C = _check(p_sum, p_dev, global_dist, class_weights, sizes)
    out = torch.empty((B, V, V), dtype=torch.float32, device=p_dev.device)
    if B == 0 or V == 0:
        return out
    triton, swap_kernel, _ = _kernels()
    grid = (B, triton.cdiv(V, BLOCK_I))
    with torch.cuda.device(p_dev.device):
        swap_kernel[grid](p_sum, p_dev, global_dist, class_weights, sizes,
                          out, V, C, BLOCK_I=BLOCK_I, BLOCK_J=BLOCK_J,
                          BLOCK_C=_block_c(C), num_warps=4)
    count_launch("wemd_swap", p_dev.shape)
    return out


def wemd_add_triton(p_sum, p_dev, global_dist, class_weights, sizes):
    """[B, V] f32 add row (sizes >= 0)."""
    B, V, C = _check(p_sum, p_dev, global_dist, class_weights, sizes)
    out = torch.empty((B, V), dtype=torch.float32, device=p_dev.device)
    if B == 0 or V == 0:
        return out
    triton, _, add_kernel = _kernels()
    grid = (B, triton.cdiv(V, BLOCK_V))
    with torch.cuda.device(p_dev.device):
        add_kernel[grid](p_sum, p_dev, global_dist, class_weights, sizes,
                         out, V, C, BLOCK_V=BLOCK_V, BLOCK_C=_block_c(C),
                         num_warps=4)
    count_launch("wemd_add", p_dev.shape)
    return out
