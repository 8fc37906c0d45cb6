"""The design of the WKV backward kernel (``csrc/wkv_bwd.cu``, K5-bwd),
emulated in torch on the CPU: the chunks walked from the last, carrying
G; per chunk the log-space decays, the chunk products on the tensor
cores (B = dy v^T, SD = dy S0^T, GV = v G^T, dv = KD G + A^T dy and G's
update 2^lct G + RD^T dy) as ``mma.sync`` m16n8k8 TF32 steps of depth 8
with each f32 operand split into TF32 hi + lo (rounded on the bits, as
``cvt.rna.tf32.f32`` rounds) and lo hi + hi lo + hi hi added in f32
(3xTF32; for all but G's update, each of the three in an accumulator of
its own), and on the CUDA cores the forward's A, X = rowsum(G * S0) and
the dr/dk/dw block in the kernel's order: for each step t the factors
e[t][q] k_q of q < t, then the steps s > t, every multiply-add fused,
each factor e a running product of the steps' decays 2^(lc[i] - lc[i-1])
(each at most 1).

The emulation is held to the plain backward in f64
(``kernels/ref.py:wkv_bwd_ref``) at ``WKV_BWD_ERR_MULT`` times the f32
plain version's error, the bound the card holds the kernel to
(``chip_smoke.py``, ``tests/test_torch_kernels_cuda.py``); the same
design with one TF32 product in place of the split misses it.  The
kernel itself runs only on the card."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref

WKV_BWD_ERR_MULT = 16           # chip_smoke.py's and the card tests' bound
L = 16                          # steps a chunk
LO = 1e-8                       # the decay's clip
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def tf32(x):
    """x rounded to TF32 on its bits: 13 low mantissa bits dropped, to
    nearest, ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mma(a, b, c=None, split=True):
    """c + a @ b as the kernel's m16n8k8 steps: depth 8 at a time, each
    step adding lo hi, hi lo, then hi hi (3xTF32) into c, or tf32(a)
    tf32(b) alone; f32 sums (G's update)."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1]) if c is None else c
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ah, bh = tf32(ak), tf32(bk)
        if split:
            al, bl = tf32(ak - ah), tf32(bk - bh)
            out = out + al @ bh
            out = out + ah @ bl
        out = out + ah @ bh
    return out


def mma_sep(a, b, split=True, more=()):
    """a @ b (+ each (a, b) of ``more``) with lo hi, hi lo and hi hi
    summed over the k steps in three accumulators of their own, added
    at the end as (lo hi + hi lo) + hi hi (``Acc3``: B, SD, GV, dv)."""
    acc = [torch.zeros(*a.shape[:-1], b.shape[-1]) for _ in range(3)]
    for x, y in ((a, b), *more):
        for k0 in range(0, x.shape[-1], 8):
            xk, yk = x[..., k0:k0 + 8], y[..., k0:k0 + 8, :]
            xh, yh = tf32(xk), tf32(yk)
            if split:
                acc[0] = acc[0] + tf32(xk - xh) @ yh
                acc[1] = acc[1] + xh @ tf32(yk - yh)
            acc[2] = acc[2] + xh @ yh
    return (acc[0] + acc[1]) + acc[2]


def fma(a, b, c):
    """a * b + c rounded once to f32, as the card's FMA."""
    return (a.double() * b.double() + c.double()).float()


def chunk_states(r, k, v, w, state):
    """The state entering each chunk of 16 steps [B, ceil(T/16), H, hd,
    hd], f32, from the step-by-step forward in f64 (what K5 saves)."""
    B, T, H, hd = r.shape
    out = torch.zeros(B, -(-T // L), H, hd, hd, dtype=torch.float64)
    S, wc = state.double(), w.double().clamp(LO, 1.0)
    for t in range(T):
        if t % L == 0:
            out[:, t // L] = S
        S = wc[:, t, ..., None] * S + torch.einsum(
            "bhd,bhv->bhdv", k[:, t].double(), v[:, t].double())
    return out.float()


def kernel_design(r, k, v, w, u, chunks, dy, dstate, split=True):
    """(dr, dk, dv, dw, du, dstate0) as ``csrc/wkv_bwd.cu`` computes
    them, f32; ``split=False`` takes one TF32 product a step instead."""
    B, T, H, hd = r.shape
    nch, pad = chunks.shape[1], (-T) % L

    def blocks(a, value=0.0):       # [B, T, H, hd] -> [B, H, T + pad, hd]
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad),
                                       value=value).transpose(1, 2)
    rb, kb, vb, dyb, wb = (blocks(r), blocks(k), blocks(v), blocks(dy),
                           blocks(w, 1.0))
    inside = torch.arange(T + pad) < T
    lw = torch.where(inside[:, None], torch.log2(wb.clamp(LO, 1.0)), 0.0)
    clip_grad = torch.where((wb > LO) & (wb < 1), 1.0, torch.where(
        (wb == LO) | (wb == 1), 0.5, 0.0))
    uu = u[None, :, None].expand(B, H, 1, hd)
    G = dstate.clone()
    grads = [torch.zeros_like(rb) for _ in range(4)]
    du = torch.zeros(B, H, hd)
    for n in range(nch - 1, -1, -1):
        c0 = n * L
        S0 = chunks[:, n]
        rc, kc, vc, dyc = (x[:, :, c0:c0 + L] for x in (rb, kb, vb, dyb))
        lc = torch.cumsum(lw[:, :, c0:c0 + L], 2)
        lp = torch.cat([torch.zeros_like(lc[:, :, :1]), lc[:, :, :-1]], 2)
        lct = lc[:, :, -1:]
        RD, KD = rc * torch.exp2(lp), kc * torch.exp2(lct - lc)
        sdec = torch.exp2(lct).transpose(-1, -2)        # [B, H, hd, 1]
        # A: the tensor-core products and X
        Bm = mma_sep(dyc, vc.transpose(-1, -2), split=split)
        SD = mma_sep(dyc, S0.transpose(-1, -2), split=split)
        GV = mma_sep(vc, G.transpose(-1, -2), split=split)
        X = (G * S0).sum(-1)
        # B: the forward's A on the CUDA cores
        A = torch.zeros(B, H, L, L)
        for t in range(L):
            A[..., t, t] = (rc[:, :, t] * uu[:, :, 0] * kc[:, :, t]).sum(-1)
            for s in range(t):
                A[..., t, s] = (rc[:, :, t] * kc[:, :, s] * torch.exp2(
                    lp[:, :, t] - lc[:, :, s])).sum(-1)
        # B: dr, dk, dw a (t, d), q < t and s > t only; e[t][q] and
        # e[s][t] as running products of dec[i] = 2^(lc[i] - lc[i-1]) <= 1
        ud = uu[:, :, 0]
        dec = [None] + [torch.exp2(lc[:, :, i] - lc[:, :, i - 1])
                        for i in range(1, L)]
        for t in range(L):
            lc_t, lp_t = lc[:, :, t], lp[:, :, t]
            at, bt = torch.exp2(lct[:, :, 0] - lc_t), torch.exp2(lp_t)
            ek, e = [None] * t, torch.ones_like(lc_t)
            for q in range(t - 1, -1, -1):
                ek[q] = e * kc[:, :, q]
                if q:
                    e = e * dec[q]
            bd = Bm[..., t, t, None]
            kt, rt = kc[:, :, t], rc[:, :, t]
            drv = fma(bt, SD[:, :, t], ud * kt * bd)
            inner = bt * X
            for q in range(t):
                drv = fma(Bm[..., t, q, None], ek[q], drv)
                inner = fma(ek[q], GV[:, :, q], inner)
            dkv = fma(at, GV[:, :, t], rt * ud * bd)
            dwv = at * inner
            e = torch.ones_like(lc_t)
            for s in range(t + 1, L):
                if s > t + 1:
                    e = e * dec[s - 1]
                er = e * rc[:, :, s]
                dkv = fma(Bm[..., s, t, None], er, dkv)
                z = bt * SD[:, :, s]
                for q in range(t):
                    z = fma(ek[q], Bm[..., s, q, None], z)
                dwv = fma(er, z, dwv)
            du += rt * kt * bd
            grads[0][:, :, c0 + t] = drv
            grads[1][:, :, c0 + t] = dkv
            grads[3][:, :, c0 + t] = dwv * clip_grad[:, :, c0 + t]
        # C: dv and G's update on the tensor cores
        grads[2][:, :, c0:c0 + L] = mma_sep(
            KD, G, split=split, more=((A.transpose(-1, -2), dyc),))
        G = mma(RD.transpose(-1, -2), dyc, sdec * G, split=split)
    return (*(g.transpose(1, 2)[:, :T] for g in grads), du.sum(0), G)


def inputs(seed, B, T, H, hd, wval=None, scale=(1.0, 1.0)):
    """The card tests' inputs (``tests/test_torch_kernels_cuda.py``): w in
    [0.39, 0.99], or ``wval`` with a run of 1 over steps 20..29; r, v
    scaled by scale[0], k, dy by scale[1]."""
    rng = np.random.default_rng(seed)

    def randn(shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32))
    r, k, v = randn((B, T, H, hd)), randn((B, T, H, hd), 0.3), \
        randn((B, T, H, hd))
    w = torch.from_numpy((1 / (1 + np.exp(-rng.normal(size=(B, T, H, hd))
                                          * 2)) * 0.6 + 0.39)
                         .astype(np.float32))
    if wval is not None:
        w = torch.full_like(w, wval)
        w[:, 20:30] = 1.0
    u, s0 = randn((H, hd), 0.1), randn((B, H, hd, hd), 0.5)
    dy, ds = randn((B, T, H, hd)), randn((B, H, hd, hd))
    r, v, k, dy = r * scale[0], v * scale[0], k * scale[1], dy * scale[1]
    return r, k, v, w, u, s0, dy, ds


def ratios(got, args):
    """Each gradient's max abs error against the f64 plain backward over
    the f32 plain version's (or 2^-24 of the largest entry)."""
    plain = tref.wkv_bwd_ref(*args)
    truth = tref.wkv_bwd_ref(*(x.double() for x in args))
    out = {}
    for name, g, p, t in zip(NAMES, got, plain, truth):
        assert g.shape == t.shape and bool(torch.isfinite(g).all()), name
        err = float((g.double() - t).abs().max())
        floor = max(float((p.double() - t).abs().max()),
                    2.0 ** -24 * float(t.abs().max()))
        out[name] = err / floor
    return out


CASES = [  # B, T, H, hd, w, scale: every head size, T off the chunk of 16
    (2, 37, 2, 16, None, (1.0, 1.0)),
    (1, 20, 2, 32, None, (1.0, 1.0)),
    (1, 37, 1, 64, None, (1.0, 1.0)),
    (1, 21, 1, 128, None, (1.0, 1.0)),
    (2, 1, 1, 64, None, (1.0, 1.0)),
    (1, 48, 1, 64, 1e-8, (1.0, 1.0)),
    (1, 48, 1, 64, 1e-4, (1.0, 1.0)),
    (1, 40, 1, 128, 1e-8, (1.0, 1.0)),
    (1, 40, 1, 128, 1e-4, (1.0, 1.0)),
    (1, 37, 1, 64, None, (1e3, 1e-3)),
]


@pytest.mark.parametrize("B,T,H,hd,wval,scale", CASES)
def test_design_3xtf32_within_card_bound(B, T, H, hd, wval, scale):
    """The design with 3xTF32 products: every gradient within
    ``WKV_BWD_ERR_MULT`` times the f32 plain version's error against
    f64, at the extreme decays too (every factor at most 1)."""
    args = inputs(B + T + hd, B, T, H, hd, wval, scale)
    chunks = chunk_states(*args[:4], args[5])
    got = kernel_design(*args[:5], chunks, *args[6:])
    for name, ratio in ratios(got, args).items():
        assert ratio <= WKV_BWD_ERR_MULT, (name, ratio)


@pytest.mark.parametrize("B,T,H,hd,wval,scale", [CASES[2], CASES[3],
                                                  CASES[5]])
def test_design_single_tf32_misses_card_bound(B, T, H, hd, wval, scale):
    """One TF32 product a step (about three decimal digits) in place of
    the split: the tensor-core gradients (dv, the state's) miss the
    bound by far."""
    args = inputs(B + T + hd, B, T, H, hd, wval, scale)
    chunks = chunk_states(*args[:4], args[5])
    got = ratios(kernel_design(*args[:5], chunks, *args[6:], split=False),
                 args)
    assert got["dv"] > 4 * WKV_BWD_ERR_MULT, got
    assert got["dstate"] > 4 * WKV_BWD_ERR_MULT, got


def test_tf32_rounds_on_the_bits():
    """Round to nearest on the 13 dropped bits, ties away from zero, the
    sign kept; hi + lo carries about 21 bits of x."""
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11,
                      -(1 + 2.0 ** -11), 3.14159265])
    got = tf32(x)
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9,
                         -(1 + 2.0 ** -10), 3.140625])
    assert torch.equal(got, want)
    y = torch.randn(1000)
    hi = tf32(y)
    assert float(((hi - y) / y).abs().max()) <= 2.0 ** -11
    lo = tf32(y - hi)
    assert float(((hi + lo - y) / y).abs().max()) <= 2.0 ** -21
