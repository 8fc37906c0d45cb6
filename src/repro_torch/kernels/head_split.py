"""The LM head's f32 product on the bf16 tensor cores, exactly (K7).

The head multiplies the final norm's output xn [M, K] by its weight
[K, N] in f32.  Where both are bf16 before the model casts them up (every
bf16 config of the zoo), their products are exact in f32, so bf16
products with f32 accumulation (``mm_f32``: ``torch.mm(..., out_dtype=
torch.float32)`` on the card) form the very products of the f32 one and
sum them in f32, in another order, on tensor cores 15 times the CUDA
cores' f32 rate.  The tensor cores' accumulator drifts further than
FFMA's round-to-nearest over a long reduction, so each reduction runs in
chains whose sums meet in f32 (``FWD_CHAIN``, ``DX_CHAIN``,
``DW_CHAIN``).  ``HeadMatmulFn`` is that product with its backward:

  * forward (and a checkpoint's recompute): ``logits(xn, W)``;
  * backward: the f32 cotangent d splits into bf16 hi, mid, lo with
    hi + (mid + lo) == d (``head_split``: the kernel ``csrc/head_split.cu``
    on the card, ``split3_ref`` on the CPU); each term's product with a
    bf16 operand is again exact, so dx = sum_t term_t W^T runs as one
    [3M, N] x [N, K] product whose three [M, K] blocks are added in f32,
    smallest first (``grad_x``), and dW = sum_t xn^T term_t as one
    running sum over lo, mid, then hi (``grad_w``).  Both gradients are
    rounded to the operands' bf16, as the backward of the casts to f32
    rounds the f32 product's.

Neither TF32 (10-bit operands) nor a bf16 cast of d: every bit of d
reaches the products.  ``sharding.matmul(..., out_dtype=torch.float32)``
takes this route for bf16 operands on the card and casts anything else to
f32 first, so f32 configs and every CPU tensor keep the f32 product.

``head_split`` is counted once a launch (one a head chunk's backward) in
``kernels.common.LAUNCHES``.  On a CUDA tensor it launches the kernel or
raises; ``split3_ref`` and ``mm_f32``'s CPU branch are the plain versions
the CPU tests run the Function through.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import count_launch, load_library


@functools.cache
def _launcher():
    fn = load_library("head_split.cu").head_split_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def split3_ref(d: torch.Tensor) -> torch.Tensor:
    """d (f32) -> [3, *d.shape] bf16 (hi, mid, lo), each rounded to nearest
    even: hi + (mid + lo) == d bitwise for 2^-110 <= |d| up to bf16's
    largest finite value and for 0; below 2^-110 within 2^-134 (lo's bits
    under bf16's least subnormal are lost).  A non-finite d gives hi = d,
    mid = lo = 0."""
    hi = d.to(torch.bfloat16)
    r = d - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    finite = torch.isfinite(d)
    zero = torch.zeros((), dtype=torch.bfloat16, device=d.device)
    return torch.stack([hi, torch.where(finite, mid, zero),
                        torch.where(finite, lo, zero)])


def head_split_cuda(d: torch.Tensor) -> torch.Tensor:
    """``split3_ref`` by the kernel: d a contiguous f32 CUDA tensor."""
    if not (isinstance(d, torch.Tensor) and d.is_cuda
            and d.dtype == torch.float32 and d.is_contiguous()):
        raise ValueError("head_split_cuda takes a contiguous f32 CUDA "
                         "tensor")
    out = d.new_empty((3, *d.shape), dtype=torch.bfloat16)
    if d.numel():
        device = d.get_device()
        err = _launcher()(d.data_ptr(), out.data_ptr(), d.numel(), device,
                          torch._C._cuda_getCurrentRawStream(device))
        if err != 0:
            raise RuntimeError(f"head_split launch failed: cudaError {err}")
        count_launch("head_split", d.shape)
    return out


def head_split(d: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if d.is_cuda:
        return head_split_cuda(d)
    if d.device.type != "cpu":
        raise ValueError(f"no head_split for device {d.device}")
    return split3_ref(d)


# The tensor cores' f32 accumulator does not round to nearest as the CUDA
# cores' FFMA does: against f64 at the rwkv6-3b head chunk (H100, CUDA
# 12.8) one bf16 product over the whole reduction read 8.5x (forward,
# K 2560), 26x (dx, N 65536) and 10x (dW, M 8192) the f32 product's median
# error, growing about linearly with the reduction's length (dx over 5003
# terms at another shape: 4.2x).  So each reduction is cut into chains of
# at most these many terms, whose sums meet in f32 in the epilogue of the
# next chain's product; at the head chunk they read 2.09x, 0.81x and 1.32x
# (worst 0.44x, 0.33x, 0.77x).  dW's mid and lo terms take one chain each:
# their products' drift lies 2^-8 and 2^-16 below hi's.
FWD_CHAIN, DX_CHAIN, DW_CHAIN = 640, 2048, 1024


def mm_f32(a: torch.Tensor, b: torch.Tensor, chain: int = 0,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """a [M, R] @ b [R, N], bf16 operands, each product exact and summed
    in f32 -> f32 (added to ``out`` when given).  On the card bf16
    tensor-core products with f32 accumulation over chains of at most
    ``chain`` terms of the reduction (all R when 0), each chain's sum added
    to the running f32 sum in its product's epilogue (``torch.addmm``,
    beta 1, in place), with cuBLAS's reduced-precision reduction off for
    these calls only; on the CPU the f32 product of the operands cast
    up."""
    if not a.is_cuda:
        y = a.to(torch.float32) @ b.to(torch.float32)
        return y if out is None else out.add_(y)
    R = a.shape[1]
    L = chain or max(R, 1)
    cfg = torch.backends.cuda.matmul
    prev = cfg.allow_bf16_reduced_precision_reduction
    cfg.allow_bf16_reduced_precision_reduction = False
    try:
        for i in range(0, R, L):
            ai, bi = a[:, i:i + L], b[i:i + L]
            if out is None:
                out = torch.mm(ai, bi, out_dtype=torch.float32)
            else:
                torch.addmm(out, ai, bi, out_dtype=torch.float32, out=out)
    finally:
        cfg.allow_bf16_reduced_precision_reduction = prev
    if out is None:                     # an empty reduction
        out = a.new_zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    return out


def logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] in f32, chains of ``FWD_CHAIN``."""
    return mm_f32(x, w, FWD_CHAIN)


def grad_x(terms: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_t terms[t] @ w^T in f32 for terms [3, M, N] (hi, mid, lo) and
    w [K, N]: one [3M, N] x [N, K] product in chains of ``DX_CHAIN``, its
    blocks added smallest first -> [M, K] f32."""
    _, M, N = terms.shape
    part = mm_f32(terms.view(3 * M, N), w.t(), DX_CHAIN).view(3, M, -1)
    return (part[2] + part[1]) + part[0]


def grad_w(x: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """x^T @ sum_t terms[t] in f32 for x [M, K] -> [K, N] f32: one running
    sum over lo, then mid, then hi (``DW_CHAIN`` chains), smallest first.
    (One [K, 3M] x [3M, N] product over [hi; mid; lo] would add the small
    terms' products into hi's running sum on the tensor cores: 33x the
    f32 product's median error.)"""
    out = mm_f32(x.t(), terms[2])
    out = mm_f32(x.t(), terms[1], out=out)
    return mm_f32(x.t(), terms[0], DW_CHAIN, out=out)


class HeadMatmulFn(torch.autograd.Function):
    """x [M, K] @ w [K, N], both bf16 -> f32, exactly as the f32 product
    of the operands cast up, on the bf16 tensor cores (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return logits(x, w)

    @staticmethod
    def backward(ctx, d):
        x, w = ctx.saved_tensors
        terms = head_split(d.contiguous())
        return (grad_x(terms, w).to(x.dtype)
                if ctx.needs_input_grad[0] else None,
                grad_w(x, terms).to(w.dtype)
                if ctx.needs_input_grad[1] else None)
