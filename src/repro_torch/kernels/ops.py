"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version in ``ref.py``; for the LM kernels (attention, WKV, RG-LRU) a
``meta`` tensor (the dry run's: shapes and op counts, no numbers) goes to
the plain version too; any other device raises.  There is no fallback:
a kernel that fails to build or launch raises.

Sharded inputs.  ``attention``, ``wkv`` and ``rglru`` take DTensors
(``repro_torch.sharding``): each rank's local shards go to the kernel
(on the card) or the plain version (on the CPU) through ``local_map``,
with the placements the caller's ``constrain`` set on the first input
(q, r, a).  Batch and heads (channels for the RG-LRU) may be sharded; so
may attention's query sequence (context parallelism: every rank holds
all the keys, and the kernel masks its shard at the shard's own query
offset).  A placement a kernel cannot take locally (a sharded key
sequence, a sharded time axis of a scan, a partial sum on the first
input) raises ``ValueError`` naming it; nothing is gathered quietly.
The other inputs are redistributed to the first's placements (a local
slice or a reduction of a partial sum, never a gather of the sharded
axis).  The FL kernels take no DTensor.  Inputs are cast to f32
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
from repro_torch.sharding import as_dtensor, is_dtensor, partial_where_split


def _route(x: torch.Tensor, meta: bool = False) -> str:
    """"cuda" (the kernel), "cpu" (the plain version), or with ``meta``
    (the LM kernels, which the dry run traces) "meta" (the plain
    version)."""
    if is_dtensor(x):
        raise ValueError("this kernel takes no DTensor; pass local tensors")
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu" or (meta and x.device.type == "meta"):
        return x.device.type
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
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset, scale)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels.flash_attention import (
            flash_attention_bwd_cuda, tc_aligned)
        q, k, v = ctx.saved_tensors
        causal, window, q_offset, scale = ctx.mask
        # the kernel reads a contiguous last axis, and on the bf16 route
        # rows in 16-byte pieces: a dense copy of any other dO
        if do.stride(3) != 1 or (do.dtype == torch.bfloat16
                                 and not tc_aligned(do)):
            do = do.clone(memory_format=torch.contiguous_format)
        return (*flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                          window=window, q_offset=q_offset,
                                          scale=scale),
                None, None, None, None)


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


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int | None = None, scale: float | None = None):
    """q [B,H,S,hd], k [B,KV,T,hd], v [B,KV,T,hdv] (KV divides H; strided
    views allowed) -> [B,H,S,hdv] in q's dtype; differentiable on both
    routes.  ``q_offset``: the key position of query 0, T - S by default;
    ``scale``: 1/sqrt(hd) by default.  hdv is hd, or on the card one of
    ``flash_attention.HEAD_PAIRS`` (latent attention's q/k 192, v 128).
    DTensor inputs run on their local shards (module docstring)."""
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal, window, q_offset, scale)
    if _route(q, meta=True) == "cuda":
        return AttentionFn.apply(q, k, v, causal, window, q_offset, scale)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)


def wkv(r, k, v, w, u, state):
    """RWKV6 WKV over r, k, v, w [B,T,H,hd] from state [B,H,hd,hd] ->
    (y [B,T,H,hd] in r's dtype, final state f32); differentiable on both
    routes.  On the card the chunk states are saved only when a gradient
    is being recorded.  DTensor inputs run on their local shards."""
    if is_dtensor(r):
        return _sharded_wkv(r, k, v, w, u, state)
    args = _f32(r, k, v, w, u, state)
    if _route(r, meta=True) == "cuda":
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
    h_T [B,D]), f32; differentiable on both routes.  DTensor inputs run
    on their local shards."""
    if is_dtensor(a):
        return _sharded_rglru(a, b, h0)
    args = _f32(a, b, h0)
    if _route(a, meta=True) == "cuda":
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


# ---------------------------------------------------------------------------
# DTensor inputs: each rank's local shards through local_map


def _first_placements(x, name, allowed, forbidden_dim, forbidden_msg):
    """x's placements, each Replicate or a Shard of a dim in ``allowed``;
    anything else raises, naming the placement and its mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = x.device_mesh.mesh_dim_names
    for i, p in enumerate(x.placements):
        if isinstance(p, Replicate) or (isinstance(p, Shard)
                                        and p.dim in allowed):
            continue
        what = (forbidden_msg if isinstance(p, Shard)
                and p.dim == forbidden_dim
                else "a placement the kernel cannot take locally")
        raise ValueError(f"{name}: placement {p} on mesh dim "
                         f"{names[i] if names else i} is {what}")
    return tuple(x.placements)


def _derived(placements, dims):
    """Placements of another input: a Shard of ``first`` dim d becomes a
    Shard of ``dims[d]`` (None: replicated there)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in placements:
        if isinstance(p, Shard) and dims.get(p.dim) is not None:
            out.append(Shard(dims[p.dim]))
        else:
            out.append(Replicate())
    return tuple(out)


def _to(x, mesh, placements, name, forbidden_dim, forbidden_msg):
    """x (a DTensor or a plain replicated tensor) at ``placements``; a
    shard of ``forbidden_dim`` raises rather than being gathered."""
    from torch.distributed.tensor import Shard
    x = as_dtensor(x, mesh)
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == forbidden_dim:
            raise ValueError(f"{name}: placement {p} on mesh dim "
                             f"{mesh.mesh_dim_names[i]} is {forbidden_msg}")
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def _shard_offset(x, dim: int) -> int:
    """The global index of this rank's first element along ``dim``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return int(offset[dim])


def _sharded_attention(q, k, v, causal, window, q_offset, scale=None):
    from torch.distributed.tensor.experimental import local_map
    seq = "a sharded key sequence"
    qpl = _first_placements(q, "attention q", (0, 1, 2), None, "")
    mesh = q.device_mesh
    kpl = _derived(qpl, {0: 0, 1: 1})       # all keys on every rank
    k = _to(k, mesh, kpl, "attention k", 2, seq)
    v = _to(v, mesh, kpl, "attention v", 2, seq)
    S, T = q.shape[2], k.shape[2]
    off = (T - S if q_offset is None else q_offset) + _shard_offset(q, 2)

    def run(ql, kl, vl):
        return attention(ql, kl, vl, causal=causal, window=window,
                         q_offset=off, scale=scale)
    # the keys are whole where the queries are split (context
    # parallelism): each rank's dk, dv are its queries' part of the sum
    kg = tuple(partial_where_split(qpl, kpl))
    return local_map(run, out_placements=list(qpl),
                     in_placements=(qpl, kpl, kpl),
                     in_grad_placements=(qpl, kg, kg),
                     device_mesh=mesh)(q, k, v)


def _sharded_wkv(r, k, v, w, u, state):
    from torch.distributed.tensor.experimental import local_map
    time = "a sharded time axis of the scan"
    rpl = _first_placements(r, "wkv r", (0, 2), 1, time)
    mesh = r.device_mesh
    upl = _derived(rpl, {2: 0})
    spl = _derived(rpl, {0: 0, 2: 1})
    k, v, w = (_to(x, mesh, rpl, f"wkv {n}", 1, time)
               for x, n in ((k, "k"), (v, "v"), (w, "w")))
    u = _to(u, mesh, upl, "wkv u", None, time)
    state = _to(state, mesh, spl, "wkv state", None, time)
    return local_map(wkv, out_placements=(rpl, spl),
                     in_placements=(rpl, rpl, rpl, rpl, upl, spl),
                     in_grad_placements=(rpl, rpl, rpl, rpl,
                                         tuple(partial_where_split(
                                             rpl, upl)), spl),
                     device_mesh=mesh)(r, k, v, w, u, state)


def _sharded_rglru(a, b, h0):
    from torch.distributed.tensor.experimental import local_map
    time = "a sharded time axis of the scan"
    apl = _first_placements(a, "rglru a", (0, 2), 1, time)
    mesh = a.device_mesh
    hpl = _derived(apl, {0: 0, 2: 1})
    b = _to(b, mesh, apl, "rglru b", 1, time)
    h0 = _to(h0, mesh, hpl, "rglru h0", None, time)
    return local_map(rglru, out_placements=(apl, hpl),
                     in_placements=(apl, apl, hpl),
                     device_mesh=mesh)(a, b, h0)
