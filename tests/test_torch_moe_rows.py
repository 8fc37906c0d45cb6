"""The held-expert MoE's dispatch and combine (kernel K8's plain versions,
``kernels/moe_rows.py``) against the gather formulation they replace,
which the tests keep as their own (``_moe_gather.py``).  The dispatch,
the combine, the dispatch's backward and the combine's d_buf bitwise
(``==``, so the sign of a zero is free); dw to f32 rounding.
Every buffer row at or past n_held holds NaN, so a pass that read one
would show it.  The routings: seeded, no assignment held, every
assignment held.  CPU only, no JAX."""
import dataclasses

import pytest
import torch
from _moe_gather import (_CombineGather, gather_layout, gather_moe_ffn_held,
                         routing)

from repro_torch.configs import get_config
from repro_torch.kernels import moe_rows as K8
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

CASES = ["seeded", "none_held", "all_held"]
DTYPES = [torch.float32, torch.bfloat16]
E, K, NH = 64, 6, 8


def nan_past(buf, n):
    buf = buf.clone()
    buf[n:] = float("nan")
    return buf


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_versions_are_the_gather_formulation(case, dtype):
    gen = torch.Generator().manual_seed(CASES.index(case))
    Tn, d = 96, 40
    N = Tn * K
    experts, w = routing(case, Tn, E, K, NH, gen)
    slot, src, offs, counts = M.held_layout(experts, 0, NH)
    g_slot, g_src, g_offs, pos, held, w_sorted = gather_layout(experts, w, 0,
                                                                NH)
    n = int(offs[-1])
    assert {"none_held": n == 0, "all_held": n == N}.get(case, 0 < n < N)
    assert same(slot, g_slot) and same(offs, g_offs)
    assert same(src[:n], g_src[:n]) and int(counts[:NH].sum()) == n

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dtype)
    x, shared, g = rnd(Tn, d), rnd(Tn, d), rnd(Tn, d)
    y_buf, d_xbuf = nan_past(rnd(N, d), n), nan_past(rnd(N, d), n)

    # 1. dispatch
    want = M._Dispatch.apply(x, g_src, g_slot)
    assert same(K8.dispatch_ref(x, src, offs)[:n], want[:n])

    # 2. combine, with the shared add and the cast
    yl = y_buf.clone().requires_grad_(True)
    wl = w.clone().requires_grad_(True)
    gathered = _CombineGather.apply(yl, wl, pos, held, g_src, w_sorted)
    want = (gathered + shared.float()).to(dtype)
    got = K8.combine_ref(y_buf, w, slot, shared)
    assert same(got, want) and not got.isnan().any()

    # 3. combine's backward
    d_want, dw_want = torch.autograd.grad(want, [yl, wl], g)
    d_buf, dw = K8.combine_bwd_ref(g, y_buf, w, slot)
    assert same(d_buf[:n], d_want[:n])
    torch.testing.assert_close(dw, dw_want, atol=1e-6, rtol=1e-5)
    assert not dw.isnan().any()

    # 4. dispatch's backward
    xl = x.clone().requires_grad_(True)
    dx_want, = torch.autograd.grad(M._Dispatch.apply(xl, g_src, g_slot),
                                   [xl], d_xbuf)
    dx = K8.dispatch_bwd_ref(d_xbuf, slot)
    assert same(dx, dx_want) and not dx.isnan().any()

    # the wrappers take the plain versions for CPU tensors
    assert same(K8.combine(y_buf, w, slot, shared), got)
    assert same(K8.dispatch_bwd(d_xbuf, slot), dx)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_held_is_the_gather_formulation(case, dtype):
    """The whole layer with gradients: the output and every gradient
    bitwise, but the router's (through the weights' dw, a dot product
    the kernel sums in its own order), to f32 rounding.  The expert
    weights' gradients are the same though the dispatch and the combine's
    backward leave the rows past n_held unwritten where the gather
    formulation wrote zeros."""
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg = dataclasses.replace(
        get_config("moonlight-16b-a3b").reduced(
            num_experts=E, experts_per_token=K, experts_held=NH),
        dtype=name, param_dtype=name)
    gen = torch.Generator().manual_seed(10 + CASES.index(case))
    p = T._index(T.init(gen, cfg)["blocks"], 0)["layer0"]["ffn"]
    p = {k: v for k, v in p.items()}
    bias = torch.randn(E, generator=gen) * 0.05
    if case != "seeded":
        at = slice(0, K) if case == "all_held" else slice(NH, NH + K)
        bias[at] += 9.0
    p["router_bias"] = bias
    named = [(n, v) for n, v in leaves(p) if v.is_floating_point()
             and n != "router_bias"]
    x = torch.randn(2, 24, cfg.d_model, generator=gen).to(dtype)
    dy = torch.randn(x.shape, generator=gen).to(dtype)

    def run(fn):
        ps = {n: v.detach().clone().requires_grad_(True) for n, v in named}
        tree = {k: v for k, v in p.items()}
        tree["shared"] = {k: ps[f"shared.{k}"] for k in p["shared"]}
        tree.update({n: ps[n] for n in ps if "." not in n})
        xs = x.clone().requires_grad_(True)
        out = fn(tree, cfg, xs)
        grads = torch.autograd.grad(out, [xs, *ps.values()], dy)
        return out, dict(zip(["x", *ps], grads))

    out, grads = run(M.moe_ffn_held)
    want, want_g = run(gather_moe_ffn_held)
    assert same(out, want) and not out.isnan().any()
    for name, gw in want_g.items():
        g = grads[name]
        assert g.dtype == gw.dtype and not g.isnan().any(), name
        if name == "router":
            torch.testing.assert_close(g, gw, atol=1e-6 * float(
                gw.abs().max()), rtol=1e-5, msg=name)
        else:
            assert same(g, gw), name


def test_kernel_wrappers_refuse_cpu_tensors():
    """``*_cuda`` refuses what the kernel cannot take; the routing wrapper
    refuses a device that is neither CUDA nor the CPU."""
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    slot = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        K8.dispatch_cuda(x, slot.reshape(-1),
                         torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError):
        K8.dispatch_bwd_cuda(x, slot)
    with pytest.raises(ValueError):
        K8.combine(x.to("meta"), torch.zeros((4, 2)).to("meta"),
                   slot.to("meta"), x.to("meta"))
