"""The port's sharding rules (``repro_torch.launch.shardings``,
``repro_torch.sharding``) held to the JAX package's.

Both sides run against stand-in meshes (no process group, no devices):
the reference's ``make_ctx`` / ``_param_rule`` read ``mesh.shape`` (a
dict) and ``mesh.axis_names``; the port's read ``mesh.mesh_dim_names``
and ``mesh.size(i)``.  Every placement the port gives is turned back into
a per-dim axis tuple and must equal the reference's PartitionSpec entry,
for all ten configs at full size, both production meshes, every
applicable shape and ``opt`` False and True: params, batches and caches.
"""
import jax
import pytest

from repro import configs as JC
from repro.launch import shapes as JSH
from repro.launch import shardings as JS
from repro.sharding import ShardingCtx as JCtx
from repro_torch import configs as TC
from repro_torch.launch import shapes as TSH
from repro_torch.launch import shardings as TS
from repro_torch import sharding as TSharding

MESHES = {
    "16x16": (("data", 16), ("model", 16)),
    "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
}


class JaxMesh:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, dims):
        self.shape = dict(dims)
        self.axis_names = tuple(a for a, _ in dims)


class TorchMesh:
    """What the port's rules read of a ``DeviceMesh``."""

    def __init__(self, dims):
        self.mesh_dim_names = tuple(a for a, _ in dims)
        self._sizes = [n for _, n in dims]
        self.ndim = len(dims)

    def size(self, i=None):
        if i is None:
            n = 1
            for s in self._sizes:
                n *= s
            return n
        return self._sizes[i]


def _norm(entry):
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _jax_spec(spec, ndim):
    entries = [_norm(e) for e in tuple(spec)]
    return entries + [()] * (ndim - len(entries))


def _torch_spec(mesh, placements, ndim):
    return [_norm(e) for e in
            TSharding.placements_to_spec(mesh, placements, ndim)]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _jax_paths(tree):
    out = {}
    for pathspec, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                        for p in pathspec)
        out[path] = leaf
    return out


@pytest.fixture(scope="module")
def specs():
    """Every config's params at full size, from both packages (meta
    tensors / ShapeDtypeStructs)."""
    out = {}
    for arch in TC.list_archs():
        out[arch] = (dict(_jax_paths(JS.param_specs(JC.get_config(arch)))),
                     TS.param_specs(TC.get_config(arch)))
    return out


def _ctx_fields(ctx):
    return (tuple(ctx.batch_axes), ctx.model_axis, tuple(ctx.fsdp_axes),
            tuple(ctx.seq_axes), ctx.tp, ctx.hybrid)


def _cases():
    for arch in TC.list_archs():
        for mesh in MESHES:
            for opt in (False, True):
                yield arch, mesh, opt


@pytest.mark.parametrize("arch,mesh,opt", list(_cases()))
def test_params_ctx_and_batches_match_reference(specs, arch, mesh, opt):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    jmesh, tmesh = JaxMesh(MESHES[mesh]), TorchMesh(MESHES[mesh])
    jparams, tparams = specs[arch]
    tpaths = dict(_paths(tparams))
    assert sorted(tpaths) == sorted(jparams)
    shapes = [s.name for s in JSH.applicable_shapes(jcfg)]
    assert shapes == [s.name for s in TSH.applicable_shapes(tcfg)]
    checked = 0
    for name in [None] + shapes:
        jshape = None if name is None else JSH.SHAPES[name]
        tshape = None if name is None else TSH.SHAPES[name]
        jctx = JS.make_ctx(jcfg, jmesh, jshape, opt=opt)
        tctx = TS.make_ctx(tcfg, tmesh, tshape, opt=opt)
        assert _ctx_fields(tctx) == _ctx_fields(jctx), name
        tpl = dict(_paths(TS.param_shardings(tparams, tcfg, tctx)))
        for path, leaf in jparams.items():
            assert tuple(tpaths[path].shape) == tuple(leaf.shape), path
            want = _jax_spec(JS._param_rule(path, leaf.shape, jcfg, jctx),
                             len(leaf.shape))
            got = _torch_spec(tmesh, tpl[path], len(leaf.shape))
            assert got == want, (arch, mesh, name, opt, path, got, want)
            checked += 1
        if name is None:
            continue
        # batches: the reference's NamedSharding stands in for its spec
        fed = "pod" in jmesh.shape and jshape.kind == "train"
        jbatch = JS.input_specs(jcfg, jshape, federated=fed)
        tbatch = TS.input_specs(tcfg, tshape, federated=fed)
        assert sorted(jbatch) == sorted(tbatch)
        orig = JS.NamedSharding
        JS.NamedSharding = lambda mesh_, spec: spec
        try:
            jbs = JS.batch_shardings(jbatch, jctx)
        finally:
            JS.NamedSharding = orig
        tbs = TS.batch_shardings(tbatch, tctx)
        for k in jbatch:
            assert tuple(tbatch[k].shape) == tuple(jbatch[k].shape), k
            nd = len(jbatch[k].shape)
            assert _torch_spec(tmesh, tbs[k], nd) == _jax_spec(jbs[k], nd)
    assert checked > 0


def _cache_cases():
    for arch in TC.list_archs():
        cfg = JC.get_config(arch)
        for mesh in MESHES:
            for s in JSH.applicable_shapes(cfg):
                if s.kind in ("decode", "prefill"):
                    yield arch, mesh, s.name


@pytest.mark.parametrize("arch,mesh,shape", list(_cache_cases()))
def test_cache_shardings_match_reference(arch, mesh, shape, monkeypatch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    jmesh, tmesh = JaxMesh(MESHES[mesh]), TorchMesh(MESHES[mesh])
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh_, spec: spec)
    for opt in (False, True):
        jctx = JS.make_ctx(jcfg, jmesh, JSH.SHAPES[shape], opt=opt)
        tctx = TS.make_ctx(tcfg, tmesh, TSH.SHAPES[shape], opt=opt)
        jcache = JS.cache_specs(jcfg, JSH.SHAPES[shape])
        jsh = _jax_paths(JS.cache_shardings(jcache, jcfg, jctx))
        jleaves = _jax_paths(jcache)
        tcache = TS.cache_specs(tcfg, TSH.SHAPES[shape])
        tleaves = dict(_paths(tcache))
        tsh = dict(_paths(TS.cache_shardings(tcache, tcfg, tctx)))
        assert sorted(tleaves) == sorted(jleaves)
        for path, leaf in jleaves.items():
            nd = len(leaf.shape)
            assert tuple(tleaves[path].shape) == tuple(leaf.shape), path
            assert _torch_spec(tmesh, tsh[path], nd) \
                == _jax_spec(jsh[path], nd), (path, opt)


@pytest.mark.parametrize("case", [
    # (mesh dims, ctx kwargs, shape, spec, expected resolved)
    ((("data", 4), ("model", 2)), {}, (8, 6, 5), ("batch", "sp", None),
     ("data", "model", None)),
    # an axis that does not divide its dim is dropped
    ((("data", 4), ("model", 2)), {}, (6, 6, 5), ("batch", "sp", None),
     (None, "model", None)),
    ((("data", 4), ("model", 2)), {}, (8, 5, 5), ("batch", "sp", None),
     ("data", None, None)),
    # "model" resolves to None without tp; "sp" always to the model axis
    ((("data", 4), ("model", 2)), {"tp": False}, (8, 6, 4),
     ("batch", None, "model"), ("data", None, None)),
    ((("data", 4), ("model", 2)), {"tp": False}, (8, 6, 4),
     ("batch", None, "sp"), ("data", None, "model")),
    # first dim wins a mesh axis
    ((("data", 4), ("model", 2)), {}, (8, 8, 8), ("sp", "model", "batch"),
     ("model", None, "data")),
    ((("pod", 2), ("data", 2), ("model", 2)),
     {"batch_axes": ("pod", "data")}, (8, 4, 4), ("batch", "batch", "sp"),
     (("pod", "data"), None, "model")),
    # a multi-axis entry that does not divide is dropped whole
    ((("pod", 2), ("data", 2), ("model", 2)),
     {"batch_axes": ("pod", "data")}, (2, 4), ("batch", "sp"),
     (None, "model")),
    # part of an entry already used: the rest of it stays
    ((("pod", 2), ("data", 2), ("model", 2)),
     {"batch_axes": ("pod", "data"), "seq_axes": ("data", "model")},
     (4, 8, 2), ("batch", "seq", None), (("pod", "data"), "model", None)),
    ((("data", 4), ("model", 2)), {"fsdp_axes": ("data",)}, (8, 3),
     ("fsdp", None), ("data", None)),
])
def test_constrain_resolution_rules(case):
    dims, kw, shape, spec, want = case
    ctx = TSharding.ShardingCtx(mesh=TorchMesh(dims), **kw)
    got = TSharding.resolve_spec(shape, ctx, spec)
    assert got == want
    jctx = JCtx(mesh=JaxMesh(dims), **kw)
    # the reference's resolution, from its own constrain body
    import repro.sharding as RS
    seen = {}

    def wsc(x, sharding):
        seen["spec"] = sharding
        return x

    orig = (RS.jax.lax.with_sharding_constraint, RS.NamedSharding)
    RS.jax.lax.with_sharding_constraint = wsc
    RS.NamedSharding = lambda mesh_, spec_: spec_
    try:
        import jax.numpy as jnp
        RS.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), jctx, *spec)
    finally:
        RS.jax.lax.with_sharding_constraint, RS.NamedSharding = orig
    assert _jax_spec(seen["spec"], len(shape)) == [_norm(e) for e in want]
    # and the placements round-trip
    pl = TSharding.spec_to_placements(ctx.mesh, got)
    assert TSharding.placements_to_spec(ctx.mesh, pl, len(shape)) == got


def test_spec_to_placements_refuses_reversed_axes():
    mesh = TorchMesh((("data", 2), ("model", 2)))
    with pytest.raises(ValueError, match="order"):
        TSharding.spec_to_placements(mesh, (("model", "data"), None))


def test_constrain_without_mesh_is_identity():
    import torch
    x = torch.ones(4, 4)
    assert TSharding.constrain(x, None, "batch", None) is x
    assert TSharding.constrain(x, TSharding.ShardingCtx(mesh=None),
                               "batch", None) is x
