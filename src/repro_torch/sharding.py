"""Sharding context threaded through the port's model code (counterpart
of ``repro/sharding.py``).

Every model function takes an optional ``ShardingCtx``.  With
``ctx=None`` (the default everywhere) nothing is constrained and every
tensor is a plain ``torch.Tensor`` on its device: the port computes what
it computed before the sharding context existed.  Under a
``torch.distributed.device_mesh.DeviceMesh`` the launcher passes a ctx
naming the mesh's dims; parameters and inputs are ``DTensor``s, and the
model ``constrain``s its activations (``DTensor.redistribute``, the
counterpart of ``with_sharding_constraint``).  The hand-written kernels
run on each rank's local shards (``kernels.ops``, through ``local_map``),
and the MoE layer runs expert-parallel (``models.moe``).

Axis convention (the reference's):
  pod   -- FL silo axis (multi-pod mesh only)
  data  -- batch / FSDP axis inside a silo
  model -- tensor-parallel axis (heads / d_ff / experts / vocab); for
           architectures whose head counts do not divide it (tp=False) it
           carries sequence parallelism and parameter storage sharding

Spec sentinels understood by ``constrain``:
  "batch"  -> ctx.batch_axes
  "model"  -> ctx.model_axis if ctx.tp else None   (TP dims: heads, d_ff)
  "sp"     -> ctx.model_axis                       (sequence parallelism)
  "seq"    -> ctx.seq_axes                         (decode KV-cache length)
  "fsdp"   -> ctx.fsdp_axes
A mesh axis is used once per spec (the first dim that names it wins), and
an axis whose size does not divide the dim is dropped, so one model code
serves reduced configs and 512-rank dry runs.

A spec is one entry a tensor dim: None, a mesh dim's name, or a tuple of
names in mesh order (a dim split over several mesh dims, the first
major: JAX's row-major tiling, which is also DTensor's order for one
tensor dim sharded over several mesh dims).  ``spec_to_placements``
turns it into one placement a mesh dim; ``placements_to_spec`` back.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Optional[object]                    # a DeviceMesh, or None
    batch_axes: Tuple[str, ...] = ("data",)   # activations' batch dim
    model_axis: Optional[str] = "model"       # tensor-parallel axis
    fsdp_axes: Tuple[str, ...] = ()           # param sharding, big tables
    seq_axes: Tuple[str, ...] = ()            # long-context KV cache axis
    tp: bool = True                           # Megatron TP (heads divide)
    # context-parallel attention with replicated attention weights and a
    # col/row-sharded MLP (the reference's --opt for odd-head archs)
    hybrid: bool = False

    @property
    def model_axis_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return axis_sizes(self.mesh)[self.model_axis]

    def axis_size(self, axes: Tuple[str, ...]) -> int:
        if self.mesh is None:
            return 1
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in axes:
            n *= sizes[a]
        return n

    def resolve(self, s):
        if s == "batch":
            return self.batch_axes
        if s == "model":
            return self.model_axis if self.tp else None
        if s == "sp":
            return self.model_axis
        if s == "seq":
            return self.seq_axes
        if s == "fsdp":
            return self.fsdp_axes
        return s


def axis_sizes(mesh) -> dict:
    """{mesh dim name: size}.  ``DeviceMesh.shape`` is a tuple (JAX's
    ``Mesh.shape`` is this dict); anything with ``mesh_dim_names`` and
    ``size(i)`` serves, so the rules run on a stand-in with no process
    group."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def resolve_spec(shape, ctx: ShardingCtx, spec):
    """The sentinels of ``spec`` resolved against ``shape`` (the
    reference's ``constrain`` body): a tuple, one entry a dim, each None,
    an axis name or a tuple of names."""
    resolved = []
    used = set()
    for dim, s in zip(shape, spec):
        s = ctx.resolve(s)
        if s is None or s == ():
            resolved.append(None)
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        # a mesh axis may appear only once per spec: first dim wins
        axes = tuple(a for a in axes if a not in used)
        size = ctx.axis_size(axes)
        if not axes or size == 0 or dim % max(size, 1) != 0:
            resolved.append(None)
        else:
            used.update(axes)
            resolved.append(axes if len(axes) > 1 else axes[0])
    resolved += [None] * (len(shape) - len(resolved))
    return tuple(resolved)


def spec_to_placements(mesh, spec) -> tuple:
    """One placement a mesh dim for the resolved ``spec`` (an entry a
    tensor dim): ``Shard(d)`` on each mesh dim that dim d names,
    ``Replicate()`` on the rest.  The names of one entry must follow the
    mesh's order (the first major), which is the order DTensor tiles a
    tensor dim sharded over several mesh dims in."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        if s is None:
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {s} does not follow the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh dim {names[i]} named twice in "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


def placements_to_spec(mesh, placements, ndim: int) -> tuple:
    """The inverse of ``spec_to_placements``: an entry a tensor dim,
    None, one name or a tuple of names in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    dims = [[] for _ in range(ndim)]
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            dims[p.dim].append(names[i])
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} has no spec")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in dims)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, ctx: Optional[ShardingCtx], *spec):
    """``x`` redistributed to ``spec`` (the sentinels resolved as the
    reference's ``constrain``) if a mesh is active; else ``x`` untouched.
    A plain tensor under a mesh is taken as replicated."""
    if ctx is None or ctx.mesh is None:
        return x
    placements = spec_to_placements(ctx.mesh,
                                    resolve_spec(x.shape, ctx, spec))
    x = as_dtensor(x, ctx.mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(ctx.mesh, placements)


def partial_where_split(split, whole) -> list:
    """``whole``'s placements with ``Partial`` on each mesh dim that
    ``split`` shards and ``whole`` replicates: the gradient placements of
    a local operand read whole by ranks that each apply it to their own
    shard of the work (each rank's gradient is its part of the sum)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Partial() if isinstance(s, Shard) and isinstance(w, Replicate)
            else w for s, w in zip(split, whole)]


def matmul(x, w, out_dtype=None):
    """``x @ w`` for x [..., K] and w [K, N] (``_mm``); for DTensors each
    rank multiplies its local shards.

    With ``out_dtype`` the product is taken in that type (the LM head's
    f32): bf16 operands on the card go to
    ``kernels.head_split.HeadMatmulFn`` (the bf16 tensor cores, every
    product exact, summed in f32); any other operands are cast to
    ``out_dtype`` first, as the caller's own casts would.

    DTensor's own product flattens x's leading dims, and where two of
    them are sharded (a batch and a sequence) the flattened dim is a
    strided shard whose redistributions DTensor plans by a graph search:
    30-45 s a product on a 3-D mesh.  Here the placements follow from
    x's, mesh dim by mesh dim: x split on a leading dim -> w whole there
    (an FSDP gather), out split the same; x split on K -> w split on its
    rows, out a partial sum; x whole -> w keeps a column split (out split
    on N) or is gathered.  The gradients' placements follow (a whole w
    read by ranks with their own tokens gets a partial-sum gradient; a
    whole x read by ranks with their own columns too)."""
    exact = (out_dtype == torch.float32 and x.is_cuda and w.is_cuda
             and x.dtype == w.dtype == torch.bfloat16)
    if out_dtype is not None and not exact:
        x, w = x.to(out_dtype), w.to(out_dtype)
    if not is_dtensor(x) and not is_dtensor(w):
        return _mm(x, w, exact)
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    lead = x.ndim - 1
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                  else p for p in x.placements])
    wt, out, xg, wg = [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim < lead:     # tokens split
            wt.append(Replicate())
            out.append(Shard(xp.dim))
            xg.append(xp)
            wg.append(Partial())
        elif isinstance(xp, Shard):                      # K split
            wt.append(Shard(0))
            out.append(Partial())
            xg.append(xp)
            wg.append(Shard(0))
        elif isinstance(wp, Shard) and wp.dim == 1:      # columns split
            wt.append(wp)
            out.append(Shard(lead))
            xg.append(Partial())
            wg.append(wp)
        else:
            wt.append(Replicate())
            out.append(Replicate())
            xg.append(Replicate())
            wg.append(Replicate())
    if tuple(w.placements) != tuple(wt):
        w = w.redistribute(mesh, wt)
    y = _mm(x.to_local(grad_placements=xg), w.to_local(grad_placements=wg),
            exact)
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    return DTensor.from_local(y, mesh, out, shape=shape,
                              stride=_contiguous_strides(shape),
                              run_check=False)


def _mm(x, w, exact=False):
    """x [..., K] @ w [K, N] as one [tokens, K] @ [K, N] product: how
    ``torch.matmul`` folds a contiguous x, here for every x, so that the
    plain and the sharded routes run the same product.  ``exact``: bf16
    operands to an f32 product through ``HeadMatmulFn``."""
    x2 = x.reshape(-1, x.shape[-1])
    if exact:
        from repro_torch.kernels.head_split import HeadMatmulFn
        y = HeadMatmulFn.apply(x2, w)
    else:
        y = x2 @ w
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _contiguous_strides(shape):
    strides, n = [], 1
    for s in reversed(shape):
        strides.append(n)
        n *= s
    return tuple(reversed(strides))


def local(x):
    """x's local shard (x itself when it is a plain tensor)."""
    return x.to_local() if is_dtensor(x) else x


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as
    replicated (every rank holds it whole); a DTensor as it is."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def sharded_scope(ctx: Optional[ShardingCtx]):
    """The context a model function runs in under ``ctx``: with a mesh,
    DTensor's implicit replication (the plain tensors a model makes, its
    positions, masks and zero states, join DTensors as replicated ones);
    without one, nothing.  Each public entry point enters it once (the
    library's scope clears its flag on exit, so scopes do not nest)."""
    if ctx is None or ctx.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def shard_tree(tree, placements_tree, mesh):
    """Each leaf of ``tree`` as a DTensor of its placements on ``mesh``.
    On a mesh of one rank the local shard is the leaf itself (no copy);
    else ``distribute_tensor`` (rank 0's values, split)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, pl):
        if mesh.size() == 1:
            return DTensor.from_local(x, mesh, pl, run_check=False)
        return distribute_tensor(x, mesh, pl)
    return _map2(one, tree, placements_tree)


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, list):
        return [_map2(fn, a, b) for a, b in zip(tree, other)]
    return fn(tree, other)


def full_tree(tree):
    """Each DTensor leaf of ``tree`` gathered to a plain tensor."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [full_tree(v) for v in tree]
    return tree.full_tensor() if is_dtensor(tree) else tree


__all__ = ["ShardingCtx", "as_dtensor", "axis_sizes", "constrain",
           "full_tree",
           "is_dtensor", "local", "matmul", "partial_where_split",
           "placements_to_spec", "resolve_spec",
           "shard_tree", "sharded_scope", "spec_to_placements"]
