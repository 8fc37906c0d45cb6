"""Bytes and operations of one launch of the port's kernels K3, K5 and
K5-bwd, from its shapes, and the least time the H100 could take for it:
the larger of bytes over HBM bandwidth and operations over the peak of
their type.  Each input byte is counted read once and each output byte
written once.  Frozen from the bound column of the port's kernel table
(``chip_smoke.py:bound``, ``wkv_bwd_chunk_ops``) as it stood when the
benchmark was made; later changes to the program do not move it."""
from __future__ import annotations

from portbench.counts.peaks import F32_FLOPS, HBM_BW, TF32_FLOPS

CHUNK = 16                   # K5 / K5-bwd's chunk of time steps


def k3(shapes):
    """``persample_gradnorm`` on features [V, B, d] and logits [V, B, C]
    (int64 labels): (bytes, operations, seconds)."""
    (V, B, d), (_, _, C) = shapes
    nbytes = 4 * (V * B * d + V * B * C + V * B + V) + 8 * V * B
    ops = V * (8 * B * C + 2 * B * d + 2 * B * d * C + 2 * d * C)
    return nbytes, ops, max(nbytes / HBM_BW, ops / F32_FLOPS)


def k5(shapes):
    """``wkv`` on r, k, v, w [B, T, H, hd] (f32)."""
    (B, T, H, hd), = shapes
    nbytes = 4 * (5 * B * T * H * hd + H * hd + 2 * B * H * hd * hd)
    ops = B * H * T * (5 * hd * hd + 3 * hd)
    return nbytes, ops, max(nbytes / HBM_BW, ops / F32_FLOPS)


def k5_bwd_chunk_ops(hd, L=CHUNK):
    """(f32 operations on the CUDA cores, TF32 operations on the tensor
    cores) of one chunk of one (batch, head) of K5-bwd, counted from its
    code (an FMA two; each tensor-core multiply-add three TF32
    products)."""
    pairs = L * (L - 1) // 2
    per_d = 2 * (L - 1) + sum(17 + 6 * t + (L - 1 - t) * (7 + 2 * t)
                              for t in range(L))
    f32 = (10 * L * hd + hd + 2 * L * hd + 5 * pairs * hd + 3 * L * hd
           + 3 * hd * hd + per_d * hd)
    macs = 4 * L * hd * hd + 2 * L * L * hd
    return f32, 3 * 2 * macs


def k5_bwd(shapes):
    """``wkv_bwd`` on r [B, T, H, hd]: reads r, k, v, w, dy, u, the chunk
    states and dS_T, writes dr, dk, dv, dw, du and dS_0; the CUDA cores'
    and the tensor cores' operations run side by side (the larger
    time)."""
    (B, T, H, hd), = shapes
    nch = -(-T // CHUNK)
    nbytes = 4 * (9 * B * T * H * hd + 2 * H * hd
                  + (B * nch + 2 * B) * H * hd * hd)
    f32, tc = (B * H * nch * x for x in k5_bwd_chunk_ops(hd))
    ops, t_ops = max((f32, f32 / F32_FLOPS), (tc, tc / TF32_FLOPS),
                     key=lambda x: x[1])
    return nbytes, ops, max(nbytes / HBM_BW, t_ops)


def bound_seconds(fn, shape_counts) -> float:
    """The least time of every launch in ``shape_counts`` ({shapes:
    launches}, the program's ``kernels.common.SHAPES`` of one kernel)."""
    return sum(n * fn(shapes)[2] for shapes, n in shape_counts.items())
