#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

  1. builds the port's kernels from the sources in this checkout: the
     CUDA C++ ``persample_gradnorm`` with nvcc, the Triton ``wemd_add`` /
     ``wemd_swap`` on their first launch;
  2. holds every kernel against its plain PyTorch version on the card,
     at ``tests/test_kernels.py``'s shape sweep and at the round's
     shapes (``wemd_*`` to 1e-5, sigma to 1e-3, gi_sq to atol 1e-2);
  3. solves 50 seeded random P1 problems with the torch scheduler on the
     card and requires the numpy solvers' masks and iteration counts;
  4. drives the main path: ``FederatedTrainer`` on the full-width paper
     CNN (V=64 devices, batch 32, 32x32x3 images, dropout on), 3 rounds
     of ``fedcgd-fscd`` and 3 of ``fedcgd-gs`` with
     ``scheduler_backend="torch"``; every round must have finite losses,
     2 host syncs, the numpy solver's mask on the same Problem and
     Eq. 10 sigmas (from the ``persample_gradnorm`` kernel) within
     atol 1e-3 + rtol 1e-3 of the closed form on the same features, and
     every kernel must have been launched in that run; then one more
     round of each, held to the same checks, under ``torch.profiler``
     (the device's busy share of the round and its longest kernels);
  5. times each kernel at the shapes of its last main-path launch beside
     its plain version, one library call where one computes the same
     function, and the least time the card could take (its bound):
     ``ms`` is the median per-call time of back-to-back calls by CUDA
     events (what a caller pays, launch included), ``device_ms`` the
     kernels' own device time from a ``torch.profiler`` trace.

Before the last line come a JSON object with one entry per kernel and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SIGMA_ATOL = SIGMA_RTOL = 1e-3  # the round's sigmas vs the closed form
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12         # H100 SXM f32, outside the tensor cores
TPU_KERNELS = {
    "wemd_add": "src/repro/kernels/wemd_swap.py:115",
    "wemd_swap": "src/repro/kernels/wemd_swap.py:74",
    "persample_gradnorm": "src/repro/kernels/persample_gradnorm.py:65",
}
SOURCES = {
    "wemd_add": ("triton", "src/repro_torch/kernels/wemd_swap.py"),
    "wemd_swap": ("triton", "src/repro_torch/kernels/wemd_swap.py"),
    "persample_gradnorm": (
        "cuda", "src/repro_torch/kernels/csrc/persample_gradnorm.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# kernel inputs, plain versions, library yardsticks and bounds


def wemd_inputs(torch, B, V, C, size, seed, device):
    import numpy as np
    rng = np.random.default_rng(seed)
    p_dev = torch.tensor(rng.dirichlet(np.full(C, 0.4), size=(B, V)),
                         dtype=torch.float32, device=device)
    p_sum = p_dev[:, :size].sum(dim=1)
    gd = p_dev.mean(dim=1)
    cw = torch.tensor(rng.uniform(0.5, 1.5, (B, C)), dtype=torch.float32,
                      device=device)
    sizes = torch.full((B,), float(size), dtype=torch.float32,
                       device=device)
    return p_sum, p_dev, gd, cw, sizes


def psg_inputs(torch, V, B, d, C, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = torch.randn((V, B, d), generator=g).to(device)
    logits = torch.randn((V, B, C), generator=g).to(device)
    labels = torch.randint(0, C, (V, B), generator=g).to(device)
    return h, logits, labels


def cdist_add(torch, p_sum, p_dev, gd, cw, sizes):
    """wemd_add as one L1 distance: cw >= 0 folds into both sides."""
    s1 = (sizes + 1.0)[:, None, None]
    x = p_dev / s1 * cw[:, None, :]
    y = -((p_sum[:, None, :] / s1 - gd[:, None, :]) * cw[:, None, :])
    return x, y


def cdist_swap(torch, p_sum, p_dev, gd, cw, sizes):
    s = sizes[:, None, None]
    a = ((p_sum[:, None, :] - p_dev) / s - gd[:, None, :]) * cw[:, None, :]
    b = -(p_dev / s) * cw[:, None, :]
    return a, b


def bound(name, shapes):
    """(bound_ms, bound_by): bytes each input read once and each output
    written once over HBM, operations over the f32 peak."""
    if name == "wemd_add":
        (B, V, C), = shapes
        nbytes = 4 * (3 * B * C + B * V * C + B + B * V)
        ops = 6 * B * V * C
    elif name == "wemd_swap":
        (B, V, C), = shapes
        nbytes = 4 * (3 * B * C + B * V * C + B + B * V * V)
        ops = 7 * B * V * V * C
    else:
        (V, B, d), (_, _, C) = shapes
        nbytes = 4 * (V * B * d + V * B * C + V * B + V * B + V)
        ops = V * (8 * B * C + 2 * B * d + 2 * B * d * C + 2 * d * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps=7, inner=50):
    """Median over ``reps`` of the mean per-call time of ``inner``
    back-to-back calls, by CUDA events (after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def profiler_works(torch) -> bool:
    """Whether ``torch.profiler`` can trace the card here, from one
    traced no-op.  Only this probe is guarded: the profiled work itself
    runs outside any ``try``, so its failures end the script."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"profiler unavailable, device times not measured: {e}")
        return False
    return True


def device_ms(torch, fn, n=50):
    """Summed device time of every kernel ``fn`` launches, per call, from
    a ``torch.profiler`` trace (None when the trace holds no device
    time): the kernel's own time, without the host's launch path."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        total_us += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
    return total_us / n / 1e3 if total_us > 0 else None


# ---------------------------------------------------------------------------
# phases


def phase_build(torch, dev):
    from repro_torch.kernels import common, ops
    t0 = time.perf_counter()
    from repro_torch.kernels.persample_gradnorm import _launcher
    _launcher()
    t_nvcc = time.perf_counter() - t0
    times = {}
    for name, fn, args in (
            ("wemd_add", ops.wemd_add, wemd_inputs(torch, 1, 8, 10, 3, 0, dev)),
            ("wemd_swap", ops.wemd_swap,
             wemd_inputs(torch, 1, 8, 10, 3, 0, dev))):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    log(f"build: nvcc persample_gradnorm.cu {t_nvcc:.2f} s "
        f"(nvcc itself {common.BUILD_SECONDS['persample_gradnorm.cu']:.2f}"
        f" s); triton first launch wemd_add {times['wemd_add']:.2f} s, "
        f"wemd_swap {times['wemd_swap']:.2f} s")


def phase_kernel_checks(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda, persample_gradnorm_cuda_batched)
    from repro_torch.kernels.wemd_swap import wemd_add_triton, wemd_swap_triton
    worst = {}

    def close(name, got, want, atol, rtol):
        torch.cuda.synchronize()
        err = (got - want).abs()
        require(bool((err <= atol + rtol * want.abs()).all()),
                f"{name}: max abs err {float(err.max()):.3g} over tolerance")
        worst[name] = max(worst.get(name, 0.0), float(err.max()))

    swap_shapes = [(2, 16, 10), (1, 64, 10), (3, 7, 5), (2, 33, 100),
                   (1, 130, 130), (2, 19, 11), (32, 19, 10), (32, 64, 10)]
    for i, (B, V, C) in enumerate(swap_shapes):
        args = wemd_inputs(torch, B, V, C, min(5, V), 10 + i, dev)
        out = wemd_swap_triton(*args)
        require(tuple(out.shape) == (B, V, V), "wemd_swap shape")
        close("wemd_swap", out, ref.wemd_swap_ref(*args), 1e-5, 1e-5)
    add_shapes = [(2, 16, 10), (1, 64, 10), (3, 7, 5), (2, 33, 100),
                  (1, 19, 10), (1, 64, 10)]
    for i, (B, V, C) in enumerate(add_shapes):
        args = wemd_inputs(torch, B, V, C, min(3, V), 30 + i, dev)
        out = wemd_add_triton(*args)
        require(tuple(out.shape) == (B, V), "wemd_add shape")
        close("wemd_add", out, ref.wemd_add_ref(*args), 1e-5, 1e-5)
    for i, (B, d, C) in enumerate([(64, 120, 10), (100, 512, 100),
                                   (32, 48, 5), (130, 64, 16),
                                   (32, 120, 10)]):
        h, logits, labels = psg_inputs(torch, 1, B, d, C, 50 + i, dev)
        s, gi = persample_gradnorm_cuda(h[0], logits[0], labels[0])
        sr, gr = ref.persample_gradnorm_ref(h[0], logits[0], labels[0])
        close("persample_gradnorm", s, sr, 1e-3, 1e-3)
        close("persample_gradnorm.gi_sq", gi, gr, 1e-2, 1e-3)
    for i, V in enumerate((19, 64)):                 # the round's batched call
        h, logits, labels = psg_inputs(torch, V, 32, 120, 10, 70 + i, dev)
        s, gi = persample_gradnorm_cuda_batched(h, logits, labels)
        sr, gr = ref.persample_gradnorm_ref(h, logits, labels)
        close("persample_gradnorm", s, sr, 1e-3, 1e-3)
        close("persample_gradnorm.gi_sq", gi, gr, 1e-2, 1e-3)
    log("kernels vs plain: " + ", ".join(
        f"{k} max abs err {v:.3g}" for k, v in worst.items()))


def phase_scheduler(torch, dev):
    import numpy as np
    from repro_torch.core import scheduling as S
    from repro_torch.obs import Obs

    def random_problem(rng, V, C, infeasible_frac):
        p_dev = rng.dirichlet(np.full(C, 0.4), size=V)
        min_bw = rng.uniform(0.4, 1.6, V)
        if infeasible_frac:
            min_bw[rng.random(V) < infeasible_frac] = -1.0
        return S.Problem(p_dev=p_dev,
                         global_dist=rng.dirichlet(np.full(C, 3.0)),
                         class_weights=rng.uniform(0.5, 1.5, C),
                         sigma=float(rng.uniform(2.0, 6.0)), batch_size=32,
                         min_bw=min_bw, total_bw=V * 0.5)

    obs = Obs(enabled=True)
    for V in (16, 64):
        rng = np.random.default_rng(2000 + V)
        probs = [random_problem(rng, V, 10, 0.2 if t % 3 == 0 else 0.0)
                 for t in range(25)]
        for alg, fn in (("gs", S.greedy_scheduling), ("fscd", S.fscd)):
            t0 = time.perf_counter()
            got = S.solve_many(probs, alg, backend="torch", obs=obs,
                               device=dev)
            dt = time.perf_counter() - t0
            for t, (p, g) in enumerate(zip(probs, got)):
                e = fn(p)
                require(np.array_equal(e.mask, g.mask)
                        and e.iterations == g.iterations,
                        f"scheduler {alg} V={V} problem {t}: mask or "
                        f"iterations differ from numpy")
            log(f"scheduler {alg} V={V}: 25 problems equal to numpy, "
                f"{dt:.3f} s")
    c = obs.metrics.counters
    log(f"scheduler host syncs: {int(c['sched.host_syncs.torch'].value)} "
        f"over {int(c['sched.solve_many_calls.torch'].value)} batched solves")


def check_round(torch, tr, solve, tag, rec) -> tuple:
    """Hold one main-path round to the numpy solver's mask and iteration
    count on the same Problem, finite losses, 2 host syncs, and its
    kernel-computed Eq. 10 sigmas to the closed form on the same
    features; returns the sigmas' (max abs error, max relative error,
    largest closed-form sigma)."""
    import numpy as np
    from repro_torch.core import estimation as E
    from repro_torch.fl.rounds import _cnn_features_logits
    prob, sched = tr.solved[-1]
    want = solve(prob)
    require(np.array_equal(want.mask, sched.mask)
            and want.iterations == sched.iterations,
            f"{tag}: mask differs from numpy")
    require(np.isfinite(rec["mean_local_loss"]), f"{tag}: loss not finite")
    require(tr.last_round_host_syncs == 2,
            f"{tag}: {tr.last_round_host_syncs} host syncs")
    params, images, labels, sigma = tr.sigmas[-1]
    V, b = labels.shape
    feats, logits = _cnn_features_logits(
        params, tr.model.cfg, images.reshape((V * b,) + images.shape[2:]))
    closed = E.sigma_hat_lastlayer(feats.reshape(V, b, -1),
                                   logits.reshape(V, b, -1), labels)
    err = (sigma - closed).abs()
    require(bool((err <= SIGMA_ATOL + SIGMA_RTOL * closed.abs()).all()),
            f"{tag}: sigma max abs err {float(err.max()):.3g} against the "
            f"closed form")
    return (float(err.max()), float((err / closed.abs()).max()),
            float(closed.abs().max()))


def phase_main_path(torch, dev, prof_ok):
    import numpy as np
    from repro_torch.configs.paper_cnn import PAPER_CNN_CIFAR10
    from repro_torch.core import scheduling as S
    from repro_torch.data import (sort_and_partition, synthetic_image_dataset,
                                  train_test_split)
    from repro_torch.fl import FederatedTrainer, FLConfig
    from repro_torch.kernels import common
    from repro_torch.models.registry import build_model
    from repro_torch.obs import ObsConfig

    class CheckedTrainer(FederatedTrainer):
        """Keeps every (Problem, Schedule) the round solved, and the
        inputs and result of every Eq. 10 sigma call."""

        def _schedule(self, prob, *a):
            sched = super()._schedule(prob, *a)
            self.solved.append((prob, sched))
            return sched

        def _sigma_all(self, params, images, labels):
            sigma = super()._sigma_all(params, images, labels)
            self.sigmas.append((params, images, labels, sigma))
            return sigma

    t0 = time.perf_counter()
    ds = synthetic_image_dataset(num_classes=10, num_per_class=500,
                                 image_size=32, channels=3, seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 64, 1,
                               np.random.default_rng(0))
    model = build_model(PAPER_CNN_CIFAR10)
    log(f"main path data: {len(train)} train / {len(test)} test images "
        f"32x32x3, 64 devices ({time.perf_counter() - t0:.2f} s)")

    trainers = {}
    sigma_err = []
    common.reset_launches()
    for sched_name, solve in (("fedcgd-fscd", S.fscd),
                              ("fedcgd-gs", S.greedy_scheduling)):
        cfg = FLConfig(num_devices=64, available_prob=0.3, batch_size=32,
                       tau=1, scheduler=sched_name,
                       scheduler_backend="torch", seed=0, eval_every=3,
                       obs=ObsConfig(enabled=True, ring_size=16))
        tr = CheckedTrainer(model, train, test, parts, cfg)
        tr.solved, tr.sigmas = [], []
        for j in range(3):
            rec = tr.run_round(j)
            sigma_err.append(check_round(
                torch, tr, solve, f"{sched_name} round {j}", rec))
        require(all(bool(torch.isfinite(p).all())
                    for p in tr.params.values()),
                f"{sched_name}: params not finite")
        recs = tr.obs.records()
        c = tr.obs.metrics.counters
        syncs = c["sched.host_syncs.torch"].value
        calls = c["sched.solve_many_calls.torch"].value
        for r in recs:
            ph = " ".join(f"{k}={v * 1e3:.2f}ms"
                          for k, v in r["phases"].items())
            log(f"{sched_name} round {r['round']}: round={r['round_s'] * 1e3:.2f}"
                f"ms {ph} | avail={r['num_available']} "
                f"sched={r['num_scheduled']} loss={r['mean_local_loss']:.4f}"
                f" sched_iters={r['sched_iterations']} host_syncs="
                f"{r['host_syncs']}")
        log(f"{sched_name}: {syncs / calls:.1f} scheduler host syncs per "
            f"solve ({int(calls)} solves)")
        trainers[sched_name] = (tr, solve)
    launches = dict(common.LAUNCHES)
    shapes = dict(common.LAST_SHAPES)
    log(f"main path launches: {launches}")
    for name in TPU_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the main path")
    if prof_ok:
        for sched_name, (tr, solve) in trainers.items():
            sigma_err.append(profile_round(torch, sched_name, tr, solve))
    abs_err, rel_err, top = (max(e[i] for e in sigma_err) for i in range(3))
    log(f"main path sigmas (persample_gradnorm kernel) vs closed form: "
        f"max abs err {abs_err:.3g}, max rel err {rel_err:.3g}, largest "
        f"sigma {top:.4g}")
    return launches, shapes


def profile_round(torch, sched_name, tr, solve) -> tuple:
    """One more round (index 4: no evaluation in it) under
    ``torch.profiler``, held to ``check_round``'s checks: the device's
    busy share of the round's wall time (summed kernel and copy time
    over the host clock, the profiler's own cost included, so a lower
    bound) and the kernels that took longest.  Returns the round's
    sigma errors."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec = tr.run_round(4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    err = check_round(torch, tr, solve, f"{sched_name} profiled round", rec)
    evs = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    log(f"{sched_name} profiled round: wall {wall * 1e3:.2f} ms, device "
        f"busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(e.count for e in evs)} device ops; longest: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in evs[:6]))
    return err


def phase_timing(torch, dev, launches, shapes, prof_ok):
    from repro_torch.kernels import ref
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched)
    from repro_torch.kernels.wemd_swap import wemd_add_triton, wemd_swap_triton
    rows = []
    for name in TPU_KERNELS:
        shp = shapes[name]
        if name == "persample_gradnorm":
            (V, B, d), (_, _, C) = shp
            args = psg_inputs(torch, V, B, d, C, 90, dev)
            kern = lambda: persample_gradnorm_cuda_batched(*args)  # noqa: E731
            plain = lambda: ref.persample_gradnorm_ref(*args)  # noqa: E731
            got, want = kern()[0], plain()[0]
            library = None
        else:
            (B, V, C), = shp
            args = wemd_inputs(torch, B, V, C, max(1, min(5, V)), 91, dev)
            if name == "wemd_add":
                kern = lambda: wemd_add_triton(*args)  # noqa: E731
                plain = lambda: ref.wemd_add_ref(*args)  # noqa: E731
                x, y = cdist_add(torch, *args)
            else:
                kern = lambda: wemd_swap_triton(*args)  # noqa: E731
                plain = lambda: ref.wemd_swap_ref(*args)  # noqa: E731
                x, y = cdist_swap(torch, *args)
            library = lambda: torch.cdist(x, y, p=1)  # noqa: E731
            got, want = kern(), plain()
            lib_out = library().reshape(want.shape)
            require(bool(torch.allclose(lib_out, want, atol=1e-5,
                                        rtol=1e-5)),
                    f"{name}: the cdist yardstick computes another function")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain)
        lib_ms = time_ms(torch, library) if library else None
        b_ms, b_by = bound(name, shp)
        route, src = SOURCES[name]
        rows.append({"name": name, "route": route, "source": src,
                     "replaces": TPU_KERNELS[name],
                     "launches": int(launches[name]), "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "device_ms": device_ms(torch, kern) if prof_ok else None,
                     "plain_device_ms": (device_ms(torch, plain)
                                         if prof_ok else None),
                     "shape": [list(s) for s in shp]})
    log("kernels: " + "; ".join(
        f"{r['name']} median {r['ms']:.4f} ms per call, device "
        f"{r['device_ms']} ms, at {r['shape']} (plain {r['plain_ms']:.4f}"
        f" ms, bound {r['bound_ms']:.6f} ms)" for r in rows))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    card = smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    for name, fn in (("build", phase_build),
                     ("kernel checks", phase_kernel_checks),
                     ("scheduler parity", phase_scheduler)):
        t0 = time.perf_counter()
        fn(torch, dev)
        log(f"[{name}] done in {time.perf_counter() - t0:.2f} s")
    prof_ok = profiler_works(torch)
    t0 = time.perf_counter()
    launches, shapes = phase_main_path(torch, dev, prof_ok)
    log(f"[main path] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rows = phase_timing(torch, dev, launches, shapes, prof_ok)
    log(f"[timing] done in {time.perf_counter() - t0:.2f} s; "
        f"total {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
