"""Device-scheduling algorithms for P1 (paper Section V-B) + baselines.

The paper's solvers:
  * greedy_scheduling   — Algorithm 1, O(V^2)
  * fscd                — Algorithm 2, fix-sum coordinate descent, O(tV^2)
  * coordinate_descent  — the CD baseline of Fig. 3 (1-flip neighborhood)
  * exhaustive          — exact solver for small V (test oracle)

Baselines of Section VI-A:
  * best_channel (BC), best_norm (BN), power_of_choice (POC),
    fed_cbs (QCID-driven combinatorial-UCB sampling)

All solvers consume a ``Problem`` describing one round: per-device label
distributions, global distribution, class weights G_c, sigma, batch size,
per-device minimum bandwidth B_v* and the bandwidth budget B.

Batched engine
--------------
``solve_many(problems, algorithm, backend)`` solves many same-shaped
Problems at once.  ``backend="numpy"`` loops the per-problem solvers
above; ``backend="torch"`` (the default) stacks the problems into
[B, V, C] / [B, V] tensors on a device and runs GS / FSCD through the
batched float64 engine in ``repro_torch.core.scheduling_torch``, which
reproduces the numpy solvers' masks exactly.  On a CUDA device its
float32 candidate scans run in the hand-written ``wemd_add`` /
``wemd_swap`` kernels of ``repro_torch.kernels``.  ``FederatedTrainer``
selects the backend through the ``FLConfig.scheduler_backend`` knob
("numpy" | "torch").
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import wemd as WE


@dataclasses.dataclass
class Problem:
    p_dev: np.ndarray          # [V, C] device label distributions
    global_dist: np.ndarray    # [C]
    class_weights: np.ndarray  # [C] G_c  (or G * ones)
    sigma: float
    batch_size: int
    min_bw: np.ndarray         # [V] B_v* (Hz), -1 = infeasible
    total_bw: float            # B (Hz)

    @property
    def num_devices(self) -> int:
        return self.p_dev.shape[0]

    def feasible(self) -> np.ndarray:
        return (self.min_bw >= 0) & (self.min_bw <= self.total_bw)

    def objective(self, mask) -> float:
        return WE.p1_objective(mask, self.p_dev, self.global_dist,
                               self.class_weights, self.sigma,
                               self.batch_size)

    def bw_ok(self, mask) -> bool:
        mask = np.asarray(mask, bool)
        if np.any(mask & ~self.feasible()):
            return False
        return float(self.min_bw[mask].sum()) <= self.total_bw + 1e-9


@dataclasses.dataclass
class Schedule:
    mask: np.ndarray           # [V] bool
    objective: float
    wemd: float
    sampling_variance: float
    iterations: int = 0
    algorithm: str = ""

    @property
    def num_scheduled(self) -> int:
        return int(self.mask.sum())


def _make_schedule(prob: Problem, mask, iters, name) -> Schedule:
    mask = np.asarray(mask, bool)
    w = WE.wemd_of_set(prob.p_dev, mask, prob.global_dist,
                       prob.class_weights)
    sv = WE.sampling_variance(prob.sigma, int(mask.sum()), prob.batch_size)
    return Schedule(mask=mask, objective=w + sv, wemd=w,
                    sampling_variance=sv, iterations=iters, algorithm=name)


# ---------------------------------------------------------------------------
# Algorithm 1: Greedy Scheduling


def greedy_scheduling(prob: Problem) -> Schedule:
    V = prob.num_devices
    feas = prob.feasible()
    mask = np.zeros(V, bool)
    p_sum = np.zeros(prob.p_dev.shape[1])
    used_bw = 0.0
    sigma_b = prob.sigma / np.sqrt(prob.batch_size)
    w_cur = WE.wemd_of_set(prob.p_dev, mask, prob.global_dist,
                           prob.class_weights)
    iters = 0
    while True:
        cand = feas & ~mask & (prob.min_bw <= prob.total_bw - used_bw + 1e-9)
        if not cand.any():
            break
        iters += 1
        size = int(mask.sum())
        w_new = WE.wemd_add_candidates(p_sum, size, prob.p_dev,
                                       prob.global_dist, prob.class_weights)
        w_new = np.where(cand, w_new, np.inf)
        k = int(np.argmin(w_new))               # max WEMD reduction
        # sampling-variance gain of going S -> S+1
        sv_gain = sigma_b * ((1.0 / np.sqrt(size) if size else np.inf)
                             - 1.0 / np.sqrt(size + 1))
        if (w_cur - w_new[k]) + sv_gain >= 0:
            mask[k] = True
            p_sum += prob.p_dev[k]
            used_bw += prob.min_bw[k]
            w_cur = w_new[k]
        else:
            break
    return _make_schedule(prob, mask, iters, "GS")


# ---------------------------------------------------------------------------
# Algorithm 2: Fix-Sum Coordinate Descent


def fscd(prob: Problem, max_inner: int = 200) -> Schedule:
    V = prob.num_devices
    feas = prob.feasible()
    bw = np.where(feas, prob.min_bw, np.inf)
    order = np.argsort(bw, kind="stable")       # least bandwidth first
    sigma_b = prob.sigma / np.sqrt(prob.batch_size)

    best_mask, best_obj = np.zeros(V, bool), np.inf
    total_iters = 0
    # the largest feasible S: greedy-fill by least bandwidth
    cum = np.cumsum(bw[order])
    S_max = int((cum <= prob.total_bw + 1e-9).sum())

    for S in range(S_max, 0, -1):
        mask = np.zeros(V, bool)
        mask[order[:S]] = True
        p_sum = prob.p_dev[mask].sum(axis=0)
        used = float(bw[order[:S]].sum())
        w_cur = WE.wemd_of_set(prob.p_dev, mask, prob.global_dist,
                               prob.class_weights)
        for _ in range(max_inner):
            total_iters += 1
            in_idx = np.flatnonzero(mask)
            out_idx = np.flatnonzero(~mask & feas)
            if len(out_idx) == 0:
                break
            w_swap = WE.wemd_swap_candidates(
                p_sum, S, prob.p_dev, in_idx, out_idx,
                prob.global_dist, prob.class_weights)
            # bandwidth feasibility of each swap
            bw_new = used - bw[in_idx][:, None] + bw[out_idx][None, :]
            w_swap = np.where(bw_new <= prob.total_bw + 1e-9, w_swap, np.inf)
            i, j = np.unravel_index(np.argmin(w_swap), w_swap.shape)
            if w_swap[i, j] >= w_cur - 1e-12:
                break                            # local optimum
            vi, vj = in_idx[i], out_idx[j]
            mask[vi], mask[vj] = False, True
            p_sum += prob.p_dev[vj] - prob.p_dev[vi]
            used = float(bw_new[i, j])
            w_cur = float(w_swap[i, j])
        obj = w_cur + sigma_b / np.sqrt(S)
        if obj < best_obj:
            best_obj, best_mask = obj, mask.copy()
        # early exit (paper line 10): no smaller S can do better
        if S > 1 and w_cur + sigma_b / np.sqrt(S) <= sigma_b / np.sqrt(S - 1):
            break
    return _make_schedule(prob, best_mask, total_iters, "FSCD")


# ---------------------------------------------------------------------------
# CD baseline (Fig. 3): plain coordinate descent on 1-flip neighborhoods


def coordinate_descent(prob: Problem, rng: Optional[np.random.Generator] = None,
                       restarts: int = 4, max_inner: int = 400) -> Schedule:
    rng = rng or np.random.default_rng(0)
    V = prob.num_devices
    feas = prob.feasible()
    best_mask, best_obj = np.zeros(V, bool), np.inf
    total_iters = 0
    for _ in range(restarts):
        mask = rng.random(V) < 0.5
        mask &= feas
        while not prob.bw_ok(mask):              # repair random init
            on = np.flatnonzero(mask)
            if len(on) == 0:
                break
            mask[rng.choice(on)] = False
        obj = prob.objective(mask) if mask.any() else np.inf
        for _ in range(max_inner):
            total_iters += 1
            improved = False
            objs = np.full(V, np.inf)
            for v in range(V):
                if not feas[v] and not mask[v]:
                    continue
                cand = mask.copy()
                cand[v] = ~cand[v]
                if cand.any() and prob.bw_ok(cand):
                    objs[v] = prob.objective(cand)
            v = int(np.argmin(objs))
            if objs[v] < obj - 1e-12:
                mask[v] = ~mask[v]
                obj = objs[v]
                improved = True
            if not improved:
                break
        if obj < best_obj:
            best_obj, best_mask = obj, mask.copy()
    return _make_schedule(prob, best_mask, total_iters, "CD")


# ---------------------------------------------------------------------------
# exact solver (test oracle, V <= ~16)


def exhaustive(prob: Problem) -> Schedule:
    V = prob.num_devices
    assert V <= 20, "exhaustive solver is exponential"
    best_mask, best_obj = np.zeros(V, bool), np.inf
    for bits in range(1, 1 << V):
        mask = np.array([(bits >> v) & 1 for v in range(V)], bool)
        if not prob.bw_ok(mask):
            continue
        obj = prob.objective(mask)
        if obj < best_obj:
            best_obj, best_mask = obj, mask
    return _make_schedule(prob, best_mask, 1 << V, "EXH")


# ---------------------------------------------------------------------------
# batched engine entry point


SOLVE_MANY_ALGORITHMS = ("gs", "fscd", "cd")


def solve_many(problems: Sequence[Problem], algorithm: str = "fscd",
               backend: str = "torch", max_inner: int = 200,
               obs=None,
               device=None) -> List[Schedule]:
    """Solve a batch of same-shaped Problems.

    ``backend="numpy"`` loops the reference per-problem solvers;
    ``backend="torch"`` runs the batched float64 engine on ``device``
    (``None`` = the GPU; identical masks, one batched pass over the
    whole batch).  ``algorithm="cd"`` has no batched implementation and
    always uses the numpy loop.

    The torch backend's f32 candidate scans run the ``wemd_add`` /
    ``wemd_swap`` kernels on a CUDA device and their plain versions on
    the CPU.  Scheduling decisions still go through the exact-f64 top-K
    re-evaluation, so masks stay bitwise-equal to numpy.

    ``obs`` is a ``repro_torch.obs.Obs`` facade: when enabled, the
    dispatch runs under a ``solve_many.<backend>`` span and updates
    per-backend call, iteration and host-sync counters (None = the
    process-wide default, which is off unless
    ``repro_torch.obs.enable_default()`` armed it).
    """
    problems = list(problems)
    if algorithm not in SOLVE_MANY_ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}, "
                         f"expected one of {SOLVE_MANY_ALGORITHMS}")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if not problems:
        return []
    if obs is None:
        from repro_torch.obs import DEFAULT as obs
    if not obs.enabled:
        return _solve_many_impl(problems, algorithm, backend, max_inner,
                                device)[0]
    with obs.span(f"solve_many.{backend}", algorithm=algorithm,
                  batch=len(problems)):
        scheds, syncs = _solve_many_impl(problems, algorithm, backend,
                                         max_inner, device)
    m = obs.metrics
    m.counter(f"sched.solve_many_calls.{backend}").inc()
    m.counter("sched.problems_total").inc(len(problems))
    m.counter("sched.iterations_total").inc(
        sum(s.iterations for s in scheds))
    m.counter(f"sched.host_syncs.{backend}").inc(syncs)
    return scheds


def _solve_many_impl(problems: List[Problem], algorithm: str,
                     backend: str, max_inner: int,
                     device):
    """(schedules, device->host syncs the solve made)."""
    if backend == "numpy" or algorithm == "cd":
        fn = {"gs": greedy_scheduling, "fscd": fscd,
              "cd": coordinate_descent}[algorithm]
        return [fn(p) for p in problems], 0
    from repro_torch.core import scheduling_torch as ST
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if algorithm == "gs":
        return ST.solve_many_gs(problems, device=dev)
    return ST.solve_many_fscd(problems, max_inner=max_inner, device=dev)


# ---------------------------------------------------------------------------
# baselines (Section VI-A)


def _best_effort(order: np.ndarray, prob: Problem) -> np.ndarray:
    """Schedule devices in the given order until bandwidth runs out."""
    feas = prob.feasible()
    mask = np.zeros(prob.num_devices, bool)
    used = 0.0
    for v in order:
        if not feas[v]:
            continue
        if used + prob.min_bw[v] <= prob.total_bw + 1e-9:
            mask[v] = True
            used += prob.min_bw[v]
        else:
            break
    return mask


def best_channel(prob: Problem, channel_gain: np.ndarray) -> Schedule:
    order = np.argsort(-np.asarray(channel_gain))
    return _make_schedule(prob, _best_effort(order, prob), 1, "BC")


def best_norm(prob: Problem, grad_norms: np.ndarray) -> Schedule:
    order = np.argsort(-np.asarray(grad_norms))
    return _make_schedule(prob, _best_effort(order, prob), 1, "BN")


def power_of_choice(prob: Problem, losses: np.ndarray, num_sampled: int,
                    rng: Optional[np.random.Generator] = None) -> Schedule:
    rng = rng or np.random.default_rng(0)
    V = prob.num_devices
    sampled = rng.choice(V, size=min(num_sampled, V), replace=False)
    order = sampled[np.argsort(-np.asarray(losses)[sampled])]
    return _make_schedule(prob, _best_effort(order, prob), 1, "POC")


def random_schedule(prob: Problem,
                    rng: Optional[np.random.Generator] = None) -> Schedule:
    rng = rng or np.random.default_rng(0)
    order = rng.permutation(prob.num_devices)
    return _make_schedule(prob, _best_effort(order, prob), 1, "RAND")


# --- Fed-CBS [40]: QCID-minimizing sequential sampling with UCB bonus ----


def qcid(p_dev: np.ndarray, mask: np.ndarray, global_dist: np.ndarray) -> float:
    """Quadratic class-imbalance degree of the group distribution."""
    g = WE.group_distribution(p_dev, mask)
    return float(((g - global_dist) ** 2).sum())


def fed_cbs(prob: Problem, plays: np.ndarray, round_idx: int,
            ucb_beta: float = 0.05,
            rng: Optional[np.random.Generator] = None) -> Schedule:
    """Sequentially add the device minimizing group QCID minus a
    combinatorial-UCB exploration bonus, best-effort within bandwidth."""
    rng = rng or np.random.default_rng(0)
    V = prob.num_devices
    feas = prob.feasible()
    mask = np.zeros(V, bool)
    used = 0.0
    bonus = ucb_beta * np.sqrt(
        np.log(max(round_idx, 1) + 1.0) / np.maximum(plays, 1.0))
    while True:
        cand = feas & ~mask & (prob.min_bw <= prob.total_bw - used + 1e-9)
        if not cand.any():
            break
        scores = np.full(V, np.inf)
        for v in np.flatnonzero(cand):
            m2 = mask.copy()
            m2[v] = True
            scores[v] = qcid(prob.p_dev, m2, prob.global_dist) - bonus[v]
        v = int(np.argmin(scores))
        cur = qcid(prob.p_dev, mask, prob.global_dist) if mask.any() else np.inf
        if scores[v] >= cur and mask.sum() >= 1:
            break
        mask[v] = True
        used += prob.min_bw[v]
    return _make_schedule(prob, mask, 1, "FCBS")
