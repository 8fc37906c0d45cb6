"""Batched PyTorch backend for the P1 schedulers (GS / FSCD).

The counterpart of ``repro/core/scheduling_jax.py``.  It replicates the
numpy solvers' arithmetic in float64 on a torch device, so its masks and
iteration counts coincide with the per-problem numpy path, while
batching the solver over a problem axis:

  * GS (Algorithm 1) runs all problems through one loop — each
    iteration adds at most one device per problem.
  * FSCD (Algorithm 2) is batched over problems *and* over the fix-sum
    axis: every (problem, S) pair of the outer loop is an independent
    lane of a coordinate-descent loop, run in short *phases* — after
    each phase the host reads which lanes are still live and compacts
    the batch to them (padded to a ``_bucket`` size), so the batch
    shrinks as lanes converge.  The ``best``/early-exit bookkeeping of
    the numpy outer loop is replayed on the host from per-lane results.

Each candidate scan is float32: the add row / swap matrix is ranked by
(value, device index), and the best K = 16 candidates are re-evaluated
in float64 in the fixed left-to-right class order of
``core/wemd.py:class_sum``, with ties broken by device index exactly
like ``np.argmin``.  Where the K-th candidate is within f32 error of the
best, the whole row is re-evaluated instead, so a group of near-tied
candidates is never cut at rank K.  The f32 scans go through
``kernels.ops``: the hand-written ``wemd_add`` / ``wemd_swap`` kernels
on a CUDA device, their plain versions on the CPU.  Every accept/swap
decision goes through f64, so the masks stay bitwise-equal to numpy on
either device.

The loops are Python loops; each step reads two flags from the device
(any lane live, any row needing the full re-evaluation) in one
device->host copy, and each solve returns how many copies it made.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scheduling as SCH
from repro_torch.core import wemd as WE
from repro_torch.kernels import ops

_LANE_BUCKET = 32          # min lane-batch granule (see _bucket)
_TOP_K = 16
f64 = torch.float64


def _wsum(x: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """sum_c x[..., c] * cw[..., c], accumulated left to right so the
    f64 value does not depend on the device's reduction order."""
    acc = x[..., 0] * cw[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * cw[..., c]
    return acc


def _rank(w32: torch.Tensor, cw: torch.Tensor, k: int):
    """Order the f32 candidates of each row by (value, index) — stable,
    so deterministic on CUDA, where ``torch.topk`` promises no order
    among ties — and flag the rows whose K-th candidate is within the
    f32 error of the row minimum: there the K best could cut a group of
    near-tied candidates, so the f64 re-evaluation must see them all."""
    vals, order = torch.sort(w32, dim=1, stable=True)
    lo, kth = vals[:, 0].double(), vals[:, k - 1].double()
    tol = 1e-5 * (lo.abs() + cw.sum(dim=1))
    return order, (kth <= lo + tol).any()


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, V, C], idx [N, K] -> x[n, idx[n, k], :] as [N, K, C]."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


# ---------------------------------------------------------------------------
# Algorithm 1 (GS), batched over problems


def _gs_batch(p_dev, gd, cw, sigma, batch_size, min_bw, total_bw, w_cur):
    B, V, C = p_dev.shape
    dev = p_dev.device
    feas = (min_bw >= 0) & (min_bw <= total_bw[:, None])
    sigma_b = sigma / torch.sqrt(batch_size)
    K = min(_TOP_K, V)
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    arange_v = torch.arange(V, device=dev)

    mask = torch.zeros((B, V), dtype=torch.bool, device=dev)
    p_sum = torch.zeros((B, C), dtype=f64, device=dev)
    used = torch.zeros((B,), dtype=f64, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    syncs = 0
    while True:
        cand = feas & ~mask & (min_bw <= (total_bw - used)[:, None] + 1e-9)
        size = mask.sum(dim=1).to(f64)
        # f32 add row (the kernel on CUDA), ranked; the best K (or,
        # where that could cut a near-tie, all V) re-evaluated in f64
        w32 = torch.where(cand, ops.wemd_add(p_sum, p_dev, gd, cw, size),
                          torch.inf)
        order, trunc = _rank(w32, cw, K)
        syncs += 1
        flags = torch.stack([active.any(), trunc]).cpu().tolist()
        if not flags[0]:
            break
        act = active & cand.any(dim=1)
        iters = iters + act.to(torch.int32)
        topk = order[:, :V if flags[1] else K]
        new_k = (p_sum[:, None, :] + _rows(p_dev, topk)) \
            / (size[:, None, None] + 1.0)
        w64k = _wsum(torch.abs(new_k - gd[:, None, :]), cw[:, None, :])
        valid_k = torch.gather(cand, 1, topk)
        w64k = torch.where(valid_k, w64k, inf)
        wk = w64k.min(dim=1).values
        # numpy argmin tie-break: min device index among exact minima
        k = torch.where(valid_k & (w64k == wk[:, None]), topk,
                        V).min(dim=1).values.clamp(max=V - 1)
        pos = size > 0
        inv_sqrt = torch.where(
            pos, 1.0 / torch.sqrt(torch.where(pos, size, 1.0)), inf)
        sv_gain = sigma_b * (inv_sqrt - 1.0 / torch.sqrt(size + 1.0))
        accept = (w_cur - wk) + sv_gain >= 0
        upd = act & accept
        mask = mask | (upd[:, None] & (arange_v[None, :] == k[:, None]))
        pk = _rows(p_dev, k[:, None])[:, 0]
        p_sum = torch.where(upd[:, None], p_sum + pk, p_sum)
        bwk = torch.gather(min_bw, 1, k[:, None])[:, 0]
        used = torch.where(upd, used + bwk, used)
        w_cur = torch.where(upd, wk, w_cur)
        active = upd
    return mask, iters, syncs


# ---------------------------------------------------------------------------
# Algorithm 2 (FSCD), one lane per (problem, S) pair
#
# The swap matrix of lane l is ranked on its member rows [L, R, V]
# (R = max fix-sum across lanes); ties are broken by the *device-order*
# flat index (min vi*V+vj among exact minima) — precisely numpy's
# argmin-over-[in,out] tie-break, so the member-row permutation cannot
# change the selected swap.


def _fscd_phase(p_dev, gd, cw, bw, feas, total_bw, s_lane, members, mask,
                p_sum, used, w_cur, act, iters, max_inner: int,
                phase_steps: int):
    L, V, C = p_dev.shape
    R = members.shape[1]
    dev = p_dev.device
    sf_safe = s_lane.to(f64).clamp(min=1.0)
    arange_r = torch.arange(R, device=dev)
    arange_v = torch.arange(V, device=dev)
    valid_r = arange_r[None, :] < s_lane[:, None]
    K = min(_TOP_K, R * V)
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    syncs = 0
    for _ in range(phase_steps):
        live = act & (iters < max_inner)
        # float32 scan of the [R, V] swap matrix, then an exact float64
        # re-evaluation (numpy's op order) of the K best candidates — or
        # of all of them where that could cut a group of near-ties.
        # The dense [L,V,V] f32 swap matrix (the kernel on CUDA) is
        # gathered down to the member rows.
        w_dense = ops.wemd_swap(p_sum, p_dev, gd, cw, sf_safe)
        w32 = torch.gather(w_dense, 1, members[:, :, None].expand(L, R, V))
        bw_mem = torch.gather(bw, 1, members)
        bw_new = (used[:, None, None] - bw_mem[:, :, None]) + bw[:, None, :]
        ok = valid_r[:, :, None] & (~mask & feas)[:, None, :] \
            & (bw_new <= total_bw[:, None, None] + 1e-9)
        ok_flat = ok.reshape(L, R * V)
        order, trunc = _rank(
            torch.where(ok_flat, w32.reshape(L, R * V), torch.inf), cw, K)
        syncs += 1
        flags = torch.stack([live.any(), trunc]).cpu().tolist()
        if not flags[0]:
            break
        iters = iters + live.to(torch.int32)
        flat_rv = order[:, :R * V if flags[1] else K]
        vi_k = torch.gather(members, 1, flat_rv // V)
        j_k = flat_rv % V
        base = (p_sum[:, None, :] - _rows(p_dev, vi_k)) + _rows(p_dev, j_k)
        w64 = _wsum(torch.abs(base / sf_safe[:, None, None]
                              - gd[:, None, :]), cw[:, None, :])
        valid_k = torch.gather(ok_flat, 1, flat_rv)
        w64 = torch.where(valid_k, w64, inf)
        wmin = w64.min(dim=1).values
        # numpy tie-break: first (vi, vj) in device order among minima
        flat_dev = vi_k * V + j_k
        flatmin = torch.where(valid_k & (w64 == wmin[:, None]), flat_dev,
                              V * V).min(dim=1).values
        vi = (flatmin // V).clamp(max=V - 1)
        vj = (flatmin % V).clamp(max=V - 1)
        rsel = (members == vi[:, None]) & valid_r
        rpos = torch.argmax(rsel.to(torch.int32), dim=1)
        upd = live & (wmin < w_cur - 1e-12)
        members = torch.where(
            upd[:, None] & (arange_r[None, :] == rpos[:, None]),
            vj[:, None], members)
        sel_i = arange_v[None, :] == vi[:, None]
        sel_j = arange_v[None, :] == vj[:, None]
        mask = torch.where(upd[:, None], (mask & ~sel_i) | sel_j, mask)
        p_i = _rows(p_dev, vi[:, None])[:, 0]
        p_j = _rows(p_dev, vj[:, None])[:, 0]
        p_sum = torch.where(upd[:, None], p_sum + (p_j - p_i), p_sum)
        bw_i = torch.gather(bw, 1, vi[:, None])[:, 0]
        bw_j = torch.gather(bw, 1, vj[:, None])[:, 0]
        used = torch.where(upd, (used - bw_i) + bw_j, used)
        w_cur = torch.where(upd, wmin, w_cur)
        act = upd
    return (members, mask, p_sum, used, w_cur, act, iters), syncs


# ---------------------------------------------------------------------------
# host-side drivers


def _stack(problems: Sequence[SCH.Problem]):
    V = problems[0].num_devices
    C = problems[0].p_dev.shape[1]
    for p in problems:
        if p.p_dev.shape != (V, C):
            raise ValueError("solve_many requires same-shaped problems, got "
                             f"{p.p_dev.shape} vs {(V, C)}")
    return {
        "p_dev": np.stack([np.asarray(p.p_dev, np.float64)
                           for p in problems]),
        "gd": np.stack([np.asarray(p.global_dist, np.float64)
                        for p in problems]),
        "cw": np.stack([np.asarray(p.class_weights, np.float64)
                        for p in problems]),
        "sigma": np.array([p.sigma for p in problems], np.float64),
        "batch_size": np.array([p.batch_size for p in problems], np.float64),
        "min_bw": np.stack([np.asarray(p.min_bw, np.float64)
                            for p in problems]),
        "total_bw": np.array([p.total_bw for p in problems], np.float64),
    }


def solve_many_gs(problems: Sequence[SCH.Problem],
                  device=torch.device("cpu"),
                  ) -> Tuple[List[SCH.Schedule], int]:
    """(schedules, device->host syncs)."""
    device = torch.device(device)
    st = _stack(problems)
    t = {k: torch.as_tensor(v, device=device) for k, v in st.items()}
    # the empty set's WEMD, as the numpy solver computes it
    w0 = np.array([WE.wemd_of_set(p.p_dev, np.zeros(p.num_devices, bool),
                                  p.global_dist, p.class_weights)
                   for p in problems])
    masks, iters, syncs = _gs_batch(
        t["p_dev"], t["gd"], t["cw"], t["sigma"], t["batch_size"],
        t["min_bw"], t["total_bw"], torch.as_tensor(w0, device=device))
    masks, iters = masks.cpu().numpy(), iters.cpu().numpy()
    return ([SCH._make_schedule(p, masks[b], int(iters[b]), "GS")
             for b, p in enumerate(problems)], syncs + 2)


def _bucket(n: int) -> int:
    # round up to a coarse-enough granule that the lane batch keeps few
    # distinct shapes while padding waste stays ~<12%
    g = _LANE_BUCKET
    while g * 8 < n:
        g *= 2
    return -(-n // g) * g


def solve_many_fscd(problems: Sequence[SCH.Problem],
                    max_inner: int = 200,
                    phase_steps: int = 4,
                    device=torch.device("cpu"),
                    ) -> Tuple[List[SCH.Schedule], int]:
    """(schedules, device->host syncs)."""
    device = torch.device(device)
    st = _stack(problems)
    B, V, C = st["p_dev"].shape
    syncs = 0

    # lane layout: per problem, one lane per S in range(S_max, 0, -1),
    # initialized with the numpy solver's exact host arithmetic
    feas_p = (st["min_bw"] >= 0) & (st["min_bw"] <= st["total_bw"][:, None])
    bw_p = np.where(feas_p, st["min_bw"], np.inf)
    order_p = np.argsort(bw_p, axis=1, kind="stable")
    s_max = np.zeros(B, int)
    for b in range(B):
        cum = np.cumsum(bw_p[b][order_p[b]])
        s_max[b] = int((cum <= st["total_bw"][b] + 1e-9).sum())
    lane_b = np.concatenate([np.full(s_max[b], b, int) for b in range(B)]
                            or [np.zeros(0, int)])
    s_lane = np.concatenate([np.arange(s_max[b], 0, -1) for b in range(B)]
                            or [np.zeros(0, int)])
    L = len(lane_b)

    masks = np.zeros((L, V), bool)
    w_cur = np.zeros(L)
    iters = np.zeros(L, np.int32)
    if L:
        S_cap = int(s_lane.max())
        members = np.zeros((L, S_cap), np.int64)
        p_sum = np.zeros((L, C))
        used = np.zeros(L)
        for l in range(L):
            b, S = lane_b[l], int(s_lane[l])
            members[l, :S] = order_p[b][:S]
            masks[l, order_p[b][:S]] = True
            p_sum[l] = st["p_dev"][b][masks[l]].sum(axis=0)
            used[l] = float(bw_p[b][order_p[b][:S]].sum())
            w_cur[l] = WE.wemd_of_set(st["p_dev"][b], masks[l], st["gd"][b],
                                      st["cw"][b])

        def up(x):
            return torch.as_tensor(x, device=device)

        # lane-indexed constants, on the device once
        lb = up(lane_b)
        const = [up(st["p_dev"])[lb], up(st["gd"])[lb], up(st["cw"])[lb],
                 up(bw_p)[lb], up(feas_p)[lb], up(st["total_bw"])[lb],
                 up(s_lane)]
        state = [up(members), up(masks), up(p_sum), up(used), up(w_cur),
                 torch.ones(L, dtype=torch.bool, device=device),
                 up(iters)]

        # phase-chunked descent: run every live lane a few steps, read
        # the still-live set on the host, compact, repeat — so the batch
        # shrinks as lanes converge instead of spinning until the
        # slowest lane is done
        alive = np.arange(L)
        while alive.size:
            n = alive.size
            sel = up(np.concatenate([alive,
                                     np.full(_bucket(n) - n, alive[0])]))
            act_in = state[5][sel]
            act_in[n:] = False
            ins = [x[sel] for x in state]
            ins[5] = act_in
            out, s = _fscd_phase(*(x[sel] for x in const), *ins,
                                 int(max_inner), int(phase_steps))
            syncs += s
            idx = sel[:n]
            for x, o in zip(state, out):
                x[idx] = o[:n]
            live = (out[5][:n] & (out[6][:n] < max_inner)).cpu().numpy()
            syncs += 1
            alive = alive[live]
        masks = state[1].cpu().numpy()
        w_cur = state[4].cpu().numpy()
        iters = state[6].cpu().numpy()
        syncs += 3

    # replay the numpy outer loop (best tracking + early exit) exactly
    out: List[SCH.Schedule] = []
    lane0 = np.concatenate([[0], np.cumsum(s_max)])[:-1]
    for b, prob in enumerate(problems):
        sigma_b = prob.sigma / np.sqrt(prob.batch_size)
        best_mask, best_obj = np.zeros(V, bool), np.inf
        total_iters = 0
        for t, S in enumerate(range(s_max[b], 0, -1)):
            l = lane0[b] + t
            total_iters += int(iters[l])
            obj = w_cur[l] + sigma_b / np.sqrt(S)
            if obj < best_obj:
                best_obj, best_mask = obj, masks[l]
            if S > 1 and w_cur[l] + sigma_b / np.sqrt(S) \
                    <= sigma_b / np.sqrt(S - 1):
                break
        out.append(SCH._make_schedule(prob, best_mask, total_iters, "FSCD"))
    return out, syncs
