"""The LM head's f32 product on the bf16 tensor cores
(``repro_torch.kernels.head_split``, kernel K7 ``csrc/head_split.cu``).

On the CPU: the split's plain version gives back every f32 value of the
covered range bit for bit (and says what happens below it); the route's
arithmetic, emulated in f64, is the f64 product of the f32 operands; the
route's Function through its plain versions; ``sharding.matmul`` takes the
route only for bf16 operands on the card, and keeps the f32 product,
bitwise, for f32 operands and for every CPU tensor.

On the card (marker ``requires_cuda``; the file imports no JAX, so it
runs where only PyTorch is installed):

    PYTHONPATH=src python -m pytest tests/test_torch_head_split.py

the kernel bitwise equal to its plain version, the route's forward, dx and
dW held to f64 within 4x the f32 cuBLAS product's worst and median error
(the cotangent cast to bf16, the control, lands 64x or more outside it),
and a bf16 rwkv6-3b federated step launching the kernel once a chunk.
"""
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import sharding
from repro_torch.kernels import common
from repro_torch.kernels import head_split as HS

F32_ERR_MULT = 4        # the route's error against f64, at most this x f32's
CONTROL_MULT = 64       # the hi-only control's, at least this x f32's


def f32_from_bits(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32)
                            .copy())


def bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def recon(terms: torch.Tensor) -> torch.Tensor:
    hi, mid, lo = terms.to(torch.float32)
    return hi + (mid + lo)


def covered_values(n=200_000, seed=0) -> torch.Tensor:
    """Random f32 over exponents -110..+120 of both signs, with mantissas
    drawn whole and with low bits set on bf16 rounding ties: the hi term's
    (0x8000 below the top 8 bits) and the mid term's at each position."""
    rng = np.random.default_rng(seed)
    exp = rng.integers(-110, 121, n)
    man = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    patterns = np.array([0x8000, 0x7FFF, 0x8001, 0x0080, 0x0040, 0x0020,
                         0x00C0, 0x4080, 0x0001, 0xFFFF, 0x0000],
                        np.uint32)
    pick = rng.integers(0, len(patterns) + 1, n)
    tied = pick < len(patterns)
    man[tied] = (man[tied] & ~np.uint32(0xFFFF)) \
        | patterns[pick[tied] % len(patterns)]
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    b = sign | ((exp + 127).astype(np.uint32) << 23) | man
    edges = [((e + 127) << 23) | m for e in (-110, 120)
             for m in (0, 0x8000, 0x7FFFFF, 0x18000)]
    return f32_from_bits(np.concatenate([b, edges, [0]]))


# ---------------------------------------------------------------------------
# the split


def test_split_gives_back_every_covered_f32_bitwise():
    """hi + (mid + lo) in f32 is d bit for bit over exponents -110..+120,
    both signs, bf16 ties at each term, 0; -0 comes back as +0 (hi keeps
    its sign); each term is the nearest-even bf16 of what it splits."""
    d = covered_values()
    terms = HS.split3_ref(d)
    assert terms.dtype == torch.bfloat16 and terms.shape == (3, *d.shape)
    assert np.array_equal(bits(recon(terms)), bits(d))
    hi, mid, lo = terms
    assert torch.equal(hi, d.to(torch.bfloat16))
    r = d - hi.float()
    assert torch.equal(mid, r.to(torch.bfloat16))
    assert torch.equal(lo.float(), r - mid.float())       # lo is exact
    neg0 = HS.split3_ref(torch.tensor([-0.0]))
    assert float(recon(neg0)) == 0.0 and bool(torch.signbit(neg0[0].float()))


def test_split_below_bf16_normal_range_and_non_finite():
    """Below 2^-110 (f32 subnormals included) lo's bits under bf16's least
    subnormal, 2^-133, are lost: the sum is within 2^-134 of d, and not
    always d; a non-finite d gives hi = d, mid = lo = 0."""
    rng = np.random.default_rng(1)
    n = 100_000
    exp = rng.integers(-127, -110, n)               # -127: f32 subnormals
    man = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    d = f32_from_bits(sign | ((exp + 127).astype(np.uint32) << 23) | man)
    got = recon(HS.split3_ref(d)).double()
    err = (got - d.double()).abs()
    assert float(err.max()) <= 2.0 ** -134
    assert int((err > 0).sum()) > 0
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi, mid, lo = HS.split3_ref(special).float()
    assert torch.equal(hi[:2], special[:2]) and bool(hi[2].isnan())
    assert not mid.any() and not lo.any()


# ---------------------------------------------------------------------------
# the route's arithmetic


def head_operands(M, K, N, seed, device="cpu"):
    """xn [M, K] and W [K, N] in bf16, and a CE cotangent [M, N] in f32:
    (softmax - onehot) / M of logits N(0, 3^2), so its entries spread over
    many binades as the head's do."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=g, device=device)
         / K ** 0.5).to(torch.bfloat16)
    logits = 3.0 * torch.randn((M, N), generator=g, device=device)
    p = torch.softmax(logits, dim=-1)
    tgt = torch.randint(0, N, (M,), generator=g, device=device)
    p[torch.arange(M, device=device), tgt] -= 1.0
    return x, w, p / M


def test_route_in_f64_is_the_f64_product_of_the_f32_operands():
    """Each product of two bf16 values is exact in f32; the three terms'
    products, summed in f64, are the f64 product of the f32 cotangent,
    up to f64 rounding, for dx and dW alike."""
    x, w, d = head_operands(48, 40, 300, seed=2)
    a = x.float()[:, :, None] * w.float()[None]                 # f32
    assert torch.equal(a.double(), x.double()[:, :, None] * w.double()[None])
    t = HS.split3_ref(d).double()
    wd, xd, dd = w.double(), x.double(), d.double()
    dx, dx_true = sum(t[i] @ wd.T for i in range(3)), dd @ wd.T
    dw, dw_true = sum(xd.T @ t[i] for i in range(3)), xd.T @ dd
    for got, want, scale in ((dx, dx_true, dd.abs() @ wd.abs().T),
                             (dw, dw_true, xd.abs().T @ dd.abs())):
        assert bool(((got - want).abs() <= 1e-15 * scale).all())


def test_head_function_on_cpu_plain_versions():
    """``HeadMatmulFn`` through its plain versions: the forward bitwise the
    f32 product of the operands cast up; dx and dW the f64 truth's
    nearest bf16 to within one bf16 step (the f32 sums' order moves a
    rounding at most that far)."""
    x, w, d = head_operands(33, 24, 257, seed=3)
    xl, wl = (t.clone().requires_grad_(True) for t in (x, w))
    y = HS.HeadMatmulFn.apply(xl, wl)
    assert y.dtype == torch.float32
    assert torch.equal(y, x.float() @ w.float())
    y.backward(d)
    for got, want in ((xl.grad, d.double() @ w.double().T),
                      (wl.grad, x.double().T @ d.double())):
        assert got.dtype == torch.bfloat16
        step = 2.0 ** -7 * want.abs()
        assert bool(((got.double() - want).abs() <= step + 1e-30).all())


# ---------------------------------------------------------------------------
# which products take the route


class OnCard(torch.Tensor):
    """A CPU tensor that calls itself a CUDA tensor, so that the route's
    choice can be seen here; it cannot launch."""

    @property
    def is_cuda(self):
        return True


def on_card(x):
    return x.as_subclass(OnCard)


def plain(t):
    return t.as_subclass(torch.Tensor)


def cpu_route(monkeypatch):
    """The route's card calls replaced by their plain versions, the split
    counted as the kernel counts it."""
    def split(d):
        common.count_launch("head_split", d.shape)
        return HS.split3_ref(plain(d))

    def mm_f32(a, b, chain=0, out=None):
        y = plain(a).float() @ plain(b).float()
        return y if out is None else out.add_(y)
    monkeypatch.setattr(HS, "mm_f32", mm_f32)
    monkeypatch.setattr(HS, "head_split", split)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_keep_the_f32_product_bitwise(dtype):
    """On CPU tensors ``matmul(..., out_dtype=f32)`` is today's head,
    ``x.to(f32) @ w.to(f32)`` over the folded rows: bitwise the same
    logits and the same gradients, and no split launched."""
    x, w, d = head_operands(20, 16, 64, seed=4)
    x3 = x.reshape(4, 5, 16).to(dtype)
    w = w.to(dtype)
    common.reset_launches()
    a = [t.clone().requires_grad_(True) for t in (x3, w)]
    b = [t.clone().requires_grad_(True) for t in (x3, w)]
    got = sharding.matmul(a[0], a[1], out_dtype=torch.float32)
    want = (b[0].to(torch.float32).reshape(-1, 16)
            @ b[1].to(torch.float32)).reshape(4, 5, 64)
    assert torch.equal(got, want)
    got.backward(d.reshape(4, 5, 64))
    want.backward(d.reshape(4, 5, 64))
    assert torch.equal(a[0].grad, b[0].grad)
    assert torch.equal(a[1].grad, b[1].grad)
    assert common.LAUNCHES["head_split"] == 0


def test_route_taken_for_bf16_on_the_card_only(monkeypatch):
    """Operands that call themselves CUDA tensors: bf16 ones go through
    ``HeadMatmulFn`` (its backward splits once), f32 ones keep the f32
    product; a mixed pair (bf16 x, f32 W) is cast to f32 as before."""
    cpu_route(monkeypatch)
    x, w, d = head_operands(12, 16, 40, seed=5)
    for xd, wd, routed in ((torch.bfloat16, torch.bfloat16, True),
                           (torch.float32, torch.float32, False),
                           (torch.bfloat16, torch.float32, False)):
        common.reset_launches()
        xl = on_card(x.to(xd)).requires_grad_(True)
        wl = on_card(w.to(wd)).requires_grad_(True)
        y = sharding.matmul(xl.reshape(3, 4, 16), wl,
                            out_dtype=torch.float32)
        assert y.dtype == torch.float32
        assert torch.equal(plain(y).reshape(12, 40),
                           x.float() @ w.float())
        y.backward(on_card(d.reshape(3, 4, 40)))
        assert common.LAUNCHES["head_split"] == int(routed)
        assert xl.grad.dtype == xd and wl.grad.dtype == wd


def test_chunked_head_splits_once_a_chunk(monkeypatch):
    """The chunked CE's head (each chunk checkpointed, its logits
    recomputed in the backward) on the route: one split a chunk, and the
    head's gradient within a bf16 step, in relative L2, of the f32
    head's."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cpu_route(monkeypatch)
    today = sharding.matmul

    def routed(x, w, out_dtype=None):       # the route's choice on the CPU
        if out_dtype is not None and x.dtype == torch.bfloat16:
            return sharding._mm(x, w, True)
        return today(x, w, out_dtype)
    cfg = get_config("rwkv6-3b").reduced(vocab_size=96, dtype="bfloat16",
                                         param_dtype="bfloat16")
    params = T.init(torch.Generator().manual_seed(6), cfg)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 40, cfg.d_model), generator=g).to(torch.bfloat16)
    tgt = torch.randint(0, cfg.vocab_size, (2, 40), generator=g)
    grads = []
    for mm, launches in ((today, 0), (routed, 3)):
        monkeypatch.setattr(T, "matmul", mm)
        common.reset_launches()
        head = params["lm_head"].detach().clone().requires_grad_(True)
        loss = T._chunked_ce({**params, "lm_head": head}, cfg, x, tgt, None,
                             0.0, chunk=16)
        loss.backward()
        grads.append(head.grad.double())
        assert common.LAUNCHES["head_split"] == launches
    assert float((grads[1] - grads[0]).norm() / grads[0].norm()) <= 2 ** -7


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,offset", [((8192, 65536), 0),
                                          ((1000, 5003), 0),
                                          ((64, 1024), 1)])
def test_head_split_kernel_on_card(cuda, shape, offset):
    """The kernel bitwise equal to its plain version on the card, over a
    cotangent, the covered values and the specials (ragged: the
    one-element path; offset by one element: off 16-byte alignment); two
    calls bitwise equal; one launch counted a call."""
    n = int(np.prod(shape))
    x, w, d = head_operands(shape[0], 8, shape[1], seed=8, device=cuda)
    vals = torch.cat([covered_values(), torch.tensor(
        [float("inf"), -float("inf"), float("nan"), -0.0, 1e-40, 3e38])])
    flat = d.reshape(-1).clone()
    k = min(n, vals.numel())
    flat[:k] = vals[:k].to(cuda)
    buf = torch.empty(n + offset, device=cuda)
    buf[offset:] = flat
    d = buf[offset:].view(shape)
    common.reset_launches()
    got = HS.head_split_cuda(d)
    again = HS.head_split_cuda(d)
    want = HS.split3_ref(d)
    torch.cuda.synchronize()
    assert common.LAUNCHES["head_split"] == 2
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def err_stats(got, truth, sample):
    """(worst, median over ``sample``) of |got - truth| elementwise."""
    e = (got.double() - truth).abs().reshape(-1)
    return float(e.max()), float(e[sample].median())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M,K,N", [(8192, 2560, 65536), (999, 328, 5003)])
def test_head_products_on_card_held_to_f64(cuda, M, K, N):
    """At one rwkv6-3b head chunk (M 8192, K 2560, N 65536) and a ragged
    shape: the route's forward, dx and dW against f64 of the same
    operands, worst and median element error at most ``F32_ERR_MULT`` x
    those of the f32 cuBLAS product; the cotangent cast to bf16 (hi only)
    at least ``CONTROL_MULT`` x outside the f32 product's."""
    assert not torch.backends.cuda.matmul.allow_tf32
    x, w, d = head_operands(M, K, N, seed=9, device=cuda)
    terms = HS.head_split(d)
    hi = terms[0]
    g = torch.Generator(device=cuda).manual_seed(10)
    cases = {
        "forward": (lambda: HS.logits(x, w), lambda: x.float() @ w.float(),
                    None, lambda: x.double() @ w.double()),
        "dx": (lambda: HS.grad_x(terms, w), lambda: d @ w.float().T,
               lambda: HS.mm_f32(hi, w.t(), HS.DX_CHAIN),
               lambda: d.double() @ w.double().T),
        "dw": (lambda: HS.grad_w(x, terms), lambda: x.float().T @ d,
               lambda: HS.mm_f32(x.t(), hi, HS.DW_CHAIN),
               lambda: x.double().T @ d.double()),
    }
    stats = {}
    for name, (route, f32, control, f64) in cases.items():
        truth = f64()
        sample = torch.randint(0, truth.numel(), (1 << 22,), generator=g,
                               device=cuda)
        stats[name] = [err_stats(fn(), truth, sample)
                       for fn in (route, f32, control) if fn is not None]
        del truth
    print(f"(worst, median) error against f64 at {(M, K, N)}, route, f32, "
          f"hi-only: {stats}")
    for name, ((r_worst, r_med), (f_worst, f_med), *ctl) in stats.items():
        assert r_worst <= F32_ERR_MULT * f_worst, (name, r_worst, f_worst)
        assert r_med <= F32_ERR_MULT * f_med, (name, r_med, f_med)
        for c_worst, c_med in ctl:
            assert c_worst >= CONTROL_MULT * f_worst, (name, c_worst)
            assert c_med >= CONTROL_MULT * f_med, (name, c_med)


@pytest.mark.requires_cuda
def test_bf16_rwkv_federated_step_on_card_splits_once_a_chunk(cuda):
    """A bf16 reduced rwkv6-3b federated step at vocab 65536 and S 1024
    (S x vocab over 2^24: the chunked CE, two chunks of 512): the WKV
    kernels once a layer each, ``head_split`` once a chunk and nothing
    else; two steps bitwise equal; loss and gradient norm within 2 % of
    the same step on the CPU (the plain kernels, the f32 head product)."""
    from repro_torch.configs import get_config
    from repro_torch.fl.distributed import make_train_step, silo_weights
    from repro_torch.models import transformer as T
    cfg = get_config("rwkv6-3b").reduced(vocab_size=65536,
                                         dtype="bfloat16",
                                         param_dtype="bfloat16")
    params = T.init(torch.Generator().manual_seed(11), cfg)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (4, 1025)).astype(np.int64))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "schedule_weights": silo_weights(np.array([1, 0, 1, 1]), 4)}
    step = make_train_step(cfg, eta=0.1, federated=True)
    card = tree_map(lambda v: v.to(cuda), params)
    on = tree_map(lambda v: v.to(cuda), batch)
    common.reset_launches()
    got, met = step(card, on)
    torch.cuda.synchronize()
    assert dict(common.LAUNCHES) == {"wkv": cfg.num_layers,
                                     "wkv_bwd": cfg.num_layers,
                                     "head_split": 2}
    again, met2 = step(card, on)
    assert all(torch.equal(met[k], met2[k]) for k in met)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(again)))
    _, want = step(params, batch)
    for k in ("loss", "grad_norm"):
        assert torch.isfinite(met[k])
        assert abs(float(met[k]) - float(want[k])) <= 0.02 * abs(
            float(want[k])), (k, float(met[k]), float(want[k]))
