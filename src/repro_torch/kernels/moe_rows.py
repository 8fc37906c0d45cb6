"""The held-expert MoE's dispatch and combine, forward and backward (K8).

``models/moe.py`` ``moe_ffn_held`` sorts a layer's T k assignments by held
expert into a buffer of N = T k rows: the held experts' runs are its
first n_held = offs[-1] rows (``offs`` the runs' ends, int32), and the
rows past them are room for any routing, never written and never read.
``slot`` [T, k] (int64) gives each assignment's row, or N where its expert
is not held; ``src`` [N] each row's token.  Four functions touch the held
assignments only, sums in f32 from +0.0 in slot order, each rounded once
to the buffers' dtype (bf16 or f32):

  * ``dispatch(x, src, offs)`` x [T, d] -> x_buf [N, d]: x_buf[p] =
    x[src[p]] for p < n_held;
  * ``combine(y_buf, w, slot, shared)`` -> out [T, d]: out[t] = rnd(sum
    over the held j of fl(y_buf[slot[t, j]]) w[t, j], plus fl(shared[t]));
    w [T, k] f32;
  * ``combine_bwd(g, y_buf, w, slot)`` -> (d_buf [N, d], dw [T, k] f32):
    d_buf[slot[t, j]] = rnd(w[t, j] fl(g[t])), dw[t, j] = <fl(g[t]),
    fl(y_buf[slot[t, j]])> where held, else 0;
  * ``dispatch_bwd(d_xbuf, slot)`` -> dx [T, d]: dx[t] = rnd(sum over the
    held j of fl(d_xbuf[slot[t, j]])).

On a CUDA tensor each launches its entry point of ``csrc/moe_rows.cu``
(counted in ``kernels.common.LAUNCHES`` as ``moe_dispatch``,
``moe_combine``, ``moe_combine_bwd``, ``moe_dispatch_bwd``) or raises; on a
CPU tensor it runs its plain version (``*_ref``), which indexes the held
rows alone.  Both give the same bits, but dw, which matches to f32
rounding (a dot product summed in another order).  The kernel reads n_held
on the device: no host sync.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import count_launch, load_library

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "moe_dispatch_launch": [_P] * 4 + [_L] + [_I] * 4 + [_P],
    "moe_combine_launch": [_P] * 5 + [_L, _I, _L] + [_I] * 4 + [_P],
    "moe_combine_bwd_launch": [_P] * 6 + [_L, _I, _L] + [_I] * 4 + [_P],
    "moe_dispatch_bwd_launch": [_P] * 3 + [_L, _I, _L] + [_I] * 4 + [_P],
}
MAX_K = 8                       # csrc/moe_rows.cu kMaxK


@functools.cache
def _launchers():
    lib = load_library("moe_rows.cu")
    out = {}
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
        out[name] = fn
    return out


# ---------------------------------------------------------------------------
# plain versions


def _held(slot, n_rows, j):
    """(tokens whose slot j is held, their rows)."""
    t = torch.nonzero(slot[:, j] < n_rows).flatten()
    return t, slot[t, j]


def dispatch_ref(x, src, offs):
    n = int(offs[-1])
    out = x.new_empty((src.shape[0], x.shape[1]))
    out[:n] = x[src[:n]]
    return out


def combine_ref(y_buf, w, slot, shared):
    acc = torch.zeros(shared.shape, dtype=torch.float32,
                      device=shared.device)
    for j in range(slot.shape[1]):
        t, p = _held(slot, y_buf.shape[0], j)
        acc[t] = acc[t] + y_buf[p].float() * w[t, j, None]
    return (acc + shared.float()).to(shared.dtype)


def combine_bwd_ref(g, y_buf, w, slot):
    gf = g.float()
    d_buf = torch.empty_like(y_buf)
    dw = torch.zeros(slot.shape, dtype=torch.float32, device=g.device)
    for j in range(slot.shape[1]):
        t, p = _held(slot, y_buf.shape[0], j)
        d_buf[p] = (gf[t] * w[t, j, None]).to(y_buf.dtype)
        dw[t, j] = (gf[t] * y_buf[p].float()).sum(-1)
    return d_buf, dw


def dispatch_bwd_ref(d_xbuf, slot):
    acc = torch.zeros((slot.shape[0], d_xbuf.shape[1]), dtype=torch.float32,
                      device=d_xbuf.device)
    for j in range(slot.shape[1]):
        t, p = _held(slot, d_xbuf.shape[0], j)
        acc[t] = acc[t] + d_xbuf[p].float()
    return acc.to(d_xbuf.dtype)


# ---------------------------------------------------------------------------
# the kernel's wrappers


def _check(rows, index, f32=()):
    """(device, bf16 flag, vec flag) of valid inputs: ``rows`` contiguous
    [*, d] tensors of one dtype (bf16 or f32), ``index`` contiguous int64,
    ``f32`` contiguous f32, all on one CUDA device; vec where every row
    starts on 16 bytes.  Else raises ValueError."""
    dt = rows[0].dtype
    dev = rows[0].device
    if dev.type != "cuda" or dt not in (torch.bfloat16, torch.float32):
        raise ValueError("moe_rows takes bf16 or f32 CUDA tensors")
    d = rows[0].shape[-1]
    for x, want in ([(x, dt) for x in rows] + [(x, torch.int64)
                                               for x in index]
                    + [(x, torch.float32) for x in f32]):
        if x.device != dev or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"moe_rows: a {x.dtype} {tuple(x.shape)} input "
                             f"on {x.device}, want contiguous {want} on {dev}")
    if any(x.shape[-1] != d for x in rows):
        raise ValueError("moe_rows: the row tensors' widths differ")
    per = 16 // rows[0].element_size()
    vec = d % per == 0 and all(x.data_ptr() % 16 == 0 for x in rows)
    return dev.index, int(dt == torch.bfloat16), int(vec)


def _slots(slot, n_tok):
    if slot.dim() != 2 or slot.shape[0] != n_tok \
            or not 0 < slot.shape[1] <= MAX_K:
        raise ValueError(f"moe_rows: slot {tuple(slot.shape)}, want "
                         f"[{n_tok}, k] with 0 < k <= {MAX_K}")
    return slot.shape[1]


def _run(name, device, *args):
    err = _launchers()[name + "_launch"](
        *args, device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def dispatch_cuda(x, src, offs):
    if offs.dtype != torch.int32 or offs.device != x.device \
            or offs.dim() != 1 or offs.numel() == 0:
        raise ValueError("moe_dispatch: offs is a nonempty int32 vector on "
                         "x's device")
    dev, bf16, vec = _check([x], [src])
    out = x.new_empty((src.shape[0], x.shape[1]))
    out_vec = vec and out.data_ptr() % 16 == 0
    _run("moe_dispatch", dev, x.data_ptr(), src.data_ptr(),
         offs[-1:].data_ptr(), out.data_ptr(), src.shape[0], x.shape[1],
         bf16, int(out_vec))
    count_launch("moe_dispatch", x.shape, src.shape)
    return out


def combine_cuda(y_buf, w, slot, shared):
    dev, bf16, vec = _check([y_buf, shared], [slot], [w])
    k = _slots(slot, shared.shape[0])
    if w.shape != slot.shape:
        raise ValueError("moe_combine: w and slot differ in shape")
    out = torch.empty_like(shared)
    _run("moe_combine", dev, y_buf.data_ptr(), w.data_ptr(),
         slot.data_ptr(), shared.data_ptr(), out.data_ptr(), shared.shape[0],
         k, y_buf.shape[0], shared.shape[1], bf16,
         int(vec and out.data_ptr() % 16 == 0))
    count_launch("moe_combine", y_buf.shape, slot.shape)
    return out


def combine_bwd_cuda(g, y_buf, w, slot):
    dev, bf16, vec = _check([g, y_buf], [slot], [w])
    k = _slots(slot, g.shape[0])
    if w.shape != slot.shape:
        raise ValueError("moe_combine_bwd: w and slot differ in shape")
    d_buf = torch.empty_like(y_buf)
    dw = torch.empty(slot.shape, dtype=torch.float32, device=g.device)
    _run("moe_combine_bwd", dev, g.data_ptr(), y_buf.data_ptr(),
         w.data_ptr(), slot.data_ptr(), d_buf.data_ptr(), dw.data_ptr(),
         g.shape[0], k, y_buf.shape[0], g.shape[1], bf16,
         int(vec and d_buf.data_ptr() % 16 == 0))
    count_launch("moe_combine_bwd", y_buf.shape, slot.shape)
    return d_buf, dw


def dispatch_bwd_cuda(d_xbuf, slot):
    dev, bf16, vec = _check([d_xbuf], [slot])
    k = _slots(slot, slot.shape[0])
    dx = d_xbuf.new_empty((slot.shape[0], d_xbuf.shape[1]))
    _run("moe_dispatch_bwd", dev, d_xbuf.data_ptr(), slot.data_ptr(),
         dx.data_ptr(), slot.shape[0], k, d_xbuf.shape[0], d_xbuf.shape[1],
         bf16, int(vec and dx.data_ptr() % 16 == 0))
    count_launch("moe_dispatch_bwd", d_xbuf.shape, slot.shape)
    return dx


def _route(x, cuda, ref):
    """The kernel's wrapper for a CUDA tensor, the plain version for a CPU
    one."""
    if x.is_cuda:
        return cuda
    if x.device.type != "cpu":
        raise ValueError(f"no moe_rows for device {x.device}")
    return ref


def dispatch(x, src, offs):
    return _route(x, dispatch_cuda, dispatch_ref)(x, src, offs)


def combine(y_buf, w, slot, shared):
    return _route(y_buf, combine_cuda, combine_ref)(y_buf, w, slot, shared)


def combine_bwd(g, y_buf, w, slot):
    return _route(g, combine_bwd_cuda, combine_bwd_ref)(g, y_buf, w, slot)


def dispatch_bwd(d_xbuf, slot):
    return _route(d_xbuf, dispatch_bwd_cuda, dispatch_bwd_ref)(d_xbuf, slot)
