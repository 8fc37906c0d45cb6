"""The port's lossy single-cell round against the reference's
(``repro.fl.rounds.FederatedTrainer``, ``scheduler_backend="numpy"``), on
the dropout-free micro world of ``tests/test_torch_round.py``, with the
trainer-level scenarios of ``tests/test_faults.py``: zero-fault inertness,
determinism, the lossy mix (outage, dropout, deadline, corruption with a
clip, reshadow), backfill, zero-upload decay, NaN/Inf corruption,
exploded deltas clipped, and the Eq. 12 refresh-error counter.  The port
runs its ``"numpy"`` and ``"torch"`` scheduler backends.

The contract: every round's fault draws, masks, iteration counts and
every integer field of the record bitwise equal; floats and params at the
round tests' ATOL 1e-4 / RTOL 1e-3.

One case cannot be held whole: exploded deltas clipped to norm 1 under
GS at ``corrupt_scale=1e6``.  In its round 3 one scheduled device's
local step barely moves the model (a confident softmax: its f32 loss is
one rounding step of log-sum-exp), so its delta ``params_dev - params``
is f32 rounding residue, and explode then clip turn that noise into a
unit-norm upload; Eq. 12's G-hat then differs and GS schedules
differently from round 4 on (ROADMAP, "Cannot match").  That case holds
the fault draws of every round, the records and params through round 2,
the rounding-level size of the diverging delta in both packages, and
that both packages' f32 deltas lie as far from the f64 delta as from
each other.  ``python tests/test_torch_faults.py`` prints the sizes
(``drift_report``)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.estimation as JE
import repro_torch.core.estimation as TE
from repro.faults import FaultConfig as JFaultConfig
from repro.fl import FederatedTrainer as JTrainer
from repro.fl import FLConfig as JFLConfig
from repro_torch import convert
from repro_torch.faults import FaultConfig
from repro_torch.fl import FederatedTrainer, FLConfig
from test_torch_round import (assert_params, assert_records,  # noqa: F401
                              common_cfg, micro_world)

BACKENDS = ["numpy", "torch"]
LOSSY = dict(outage_prob=0.3, dropout_prob=0.2, deadline_miss_prob=0.1,
             corrupt_prob=0.4, reshadow_std_db=6.0, clip_delta_norm=5.0)
TELEMETRY_FIELDS = ("num_uploaded", "num_failed", "failure_causes",
                    "num_backfilled", "num_sanitized", "num_clipped",
                    "num_infeasible", "g_refresh_errors")


def explode(scale):
    return dict(corrupt_prob=1.0, corrupt_modes=("explode",),
                corrupt_scale=scale, clip_delta_norm=1.0)


def port_trainer(world, backend, faults=None, scheduler="fedcgd-fscd"):
    _, tm, train, test, parts = world
    kw = {} if faults is None else {"faults": faults}
    return FederatedTrainer(tm, train, test, parts, FLConfig(
        scheduler_backend=backend, device="cpu", **common_cfg(scheduler),
        **kw))


class Recorded:
    """A trainer whose fault draws, schedules (mask, iterations) and round
    core delta norms are kept, round by round."""

    def __init__(self, trainer):
        self.tr, self.draws, self.decisions, self.norms = trainer, [], [], []
        draw, sched, core = (trainer.faults.draw, trainer._schedule,
                             trainer._round_core)

        def record_draw(j):
            rf = draw(j)
            self.draws.append([np.array(getattr(rf, f.name))
                               for f in dataclasses.fields(rf)])
            return rf

        def record_schedule(*a):
            s = sched(*a)
            self.decisions.append((s.mask.copy(), int(s.iterations)))
            return s

        def record_core(*a):
            out = core(*a)
            self.norms.append(np.array(out[4][0], dtype=np.float64))
            self.core_io = (a, out)
            return out

        trainer.faults.draw = record_draw
        trainer._schedule = record_schedule
        trainer._round_core = record_core


def pair(world, backend, scheduler="fedcgd-fscd", **faults):
    """The reference and the port on one world, one seed and one fault
    config, the port starting from the reference's params."""
    jm, tm, train, test, parts = world
    jt = JTrainer(jm, train, test, parts, JFLConfig(
        scheduler_backend="numpy", faults=JFaultConfig(**faults),
        **common_cfg(scheduler)))
    tt = port_trainer(world, backend, FaultConfig(**faults), scheduler)
    tt.params = convert.params_from_jax(
        {k: np.asarray(v) for k, v in jt.params.items()}, tm.cfg,
        device="cpu")
    return Recorded(jt), Recorded(tt)


def assert_same_draws(a, b):
    assert len(a.draws) == len(b.draws)
    for da, db in zip(a.draws, b.draws):
        for x, y in zip(da, db):
            np.testing.assert_array_equal(x, y)


def assert_same_decisions(a, b):
    assert len(a.decisions) == len(b.decisions)
    for (ma, ia), (mb, ib) in zip(a.decisions, b.decisions):
        np.testing.assert_array_equal(ma, mb)
        assert ia == ib


def run_pair(jr, tr, rounds):
    """``rounds`` rounds of both, held to the contract round by round;
    returns the port's history."""
    hist = []
    for j in range(rounds):
        rj, rt = jr.tr.run_round(j), tr.tr.run_round(j)
        assert_records(rj, rt)
        hist.append(rt)
    assert_same_draws(jr, tr)
    assert_same_decisions(jr, tr)
    assert_params(jr.tr.params, tr.tr.params, tr.tr.model.cfg)
    return hist


def params_finite(tr):
    return all(bool(torch.isfinite(p).all()) for p in tr.params.values())


@pytest.mark.parametrize("backend", BACKENDS)
def test_zero_fault_config_is_bitwise_inert(micro_world, backend):
    """All-zero fault probabilities reproduce the port's fault-free
    trainer bitwise, whatever the fault seed, backfill and decay."""
    free = port_trainer(micro_world, backend)
    t1 = port_trainer(micro_world, backend, FaultConfig())
    t2 = port_trainer(micro_world, backend,
                      FaultConfig(seed=1234, backfill=False,
                                  estimate_decay=0.9))
    h0, h1, h2 = free.run(3), t1.run(3), t2.run(3)
    assert h0 == h1 == h2
    for k in free.params:
        assert torch.equal(free.params[k], t1.params[k])
        assert torch.equal(free.params[k], t2.params[k])
    assert all(h["num_failed"] == 0 and h["num_sanitized"] == 0 for h in h1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fault_determinism_across_runs(micro_world, backend):
    """One seed and one lossy config: two runs bitwise equal."""
    t1 = port_trainer(micro_world, backend, FaultConfig(**LOSSY))
    t2 = port_trainer(micro_world, backend, FaultConfig(**LOSSY))
    assert t1.run(4) == t2.run(4)
    for k in t1.params:
        assert torch.equal(t1.params[k], t2.params[k])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheduler", ["fedcgd-fscd", "fedcgd-gs"])
def test_lossy_mix_matches_reference(micro_world, scheduler, backend):
    """Outages, dropouts, deadline misses, NaN/Inf and exploded uploads
    with a clip, and a second shadow draw: six rounds held to the
    reference, the telemetry in every record."""
    jr, tr = pair(micro_world, backend, scheduler, **LOSSY)
    hist = run_pair(jr, tr, 6)
    assert params_finite(tr.tr)
    for h in hist:
        assert all(f in h for f in TELEMETRY_FIELDS)
        assert set(h["failure_causes"]) == {"dropout", "deadline", "outage",
                                            "corrupt"}
    assert sum(h["num_failed"] for h in hist) > 0
    assert sum(h["num_sanitized"] for h in hist) > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_backfill_matches_reference(micro_world, backend):
    """Heavy outages with clean candidates: the one-shot reschedule
    recovers uploads, as the reference's does; without backfill none."""
    jr, tr = pair(micro_world, backend, outage_prob=0.6, backfill=True)
    hist = run_pair(jr, tr, 6)
    assert sum(h["num_backfilled"] for h in hist) > 0
    for h in hist:
        assert h["num_uploaded"] <= h["num_scheduled"] + h["num_backfilled"]
    jr, tr = pair(micro_world, backend, outage_prob=0.6, backfill=False)
    assert all(h["num_backfilled"] == 0 for h in run_pair(jr, tr, 3))


@pytest.mark.parametrize("backend", BACKENDS)
def test_zero_upload_decay_matches_reference(micro_world, backend):
    """Nothing lands: params stay bitwise, the estimates decay toward
    their priors as the reference's do."""
    jr, tr = pair(micro_world, backend, dropout_prob=1.0,
                  estimate_decay=0.5)
    before = {k: v.clone() for k, v in tr.tr.params.items()}
    hist = run_pair(jr, tr, 3)
    for h in hist:
        assert h["num_uploaded"] == 0
        assert h["num_failed"] == h["num_scheduled"]
        assert h["failure_causes"]["dropout"] == h["num_scheduled"]
    assert all(torch.equal(before[k], v) for k, v in tr.tr.params.items())
    assert hist[-1]["g_hat"] == pytest.approx(tr.tr.cfg.g_init)


@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_corruption_matches_reference(micro_world, backend):
    """Every corrupted payload is NaN or Inf: the guard drops each one,
    none reaches the params, nothing is clipped."""
    jr, tr = pair(micro_world, backend, corrupt_prob=0.8,
                  corrupt_modes=("nan", "inf"))
    hist = run_pair(jr, tr, 4)
    assert params_finite(tr.tr)
    assert sum(h["num_sanitized"] for h in hist) > 0
    assert all(h["num_clipped"] == 0 for h in hist)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scheduler,scale", [("fedcgd-fscd", 1e6),
                                             ("fedcgd-fscd", 1e3),
                                             ("fedcgd-gs", 1e3)])
def test_explode_corruption_clipped_matches_reference(micro_world, scheduler,
                                                      scale, backend):
    """Every upload exploded and clipped back to norm 1: six rounds held
    to the reference; clipped uploads still land."""
    jr, tr = pair(micro_world, backend, scheduler, **explode(scale))
    hist = run_pair(jr, tr, 6)
    assert params_finite(tr.tr)
    assert sum(h["num_clipped"] for h in hist) > 0
    assert sum(h["num_uploaded"] for h in hist) > 0


def round3_deltas(jr, tr):
    """Round 3's diverging upload (the smaller of the two): its device,
    its raw f32 delta in each package (the reference's layout), and the
    same local step in f64 from the reference's params and batch (the
    port's model in f64 with a log-sum-exp CE in f64: both packages take
    their CE in f32)."""
    from repro_torch.models import cnn
    mask = jr.decisions[-1][0]
    up = np.flatnonzero(mask)
    v = up[np.argmin(jr.norms[-1][up])]
    (params_c, batches_c, _), out_j = jr.core_io
    cfg = tr.tr.model.cfg
    d_ref = {k: np.asarray(x[0, v], np.float64) for k, x in out_j[3].items()}
    d_port = {k: np.asarray(x, np.float64) for k, x in convert.params_to_jax(
        {k: x[0, v] for k, x in tr.core_io[1][3].items()}, cfg).items()}
    p64 = {k: x.double().requires_grad_(True) for k, x in
           convert.params_from_jax({k: np.asarray(x[0]) for k, x in
                                    params_c.items()}, cfg,
                                   device="cpu").items()}
    images = torch.from_numpy(np.array(batches_c["images"][0, v, 0]))
    labels = torch.from_numpy(np.array(batches_c["labels"][0, v, 0]))
    logits = cnn.cnn_forward(p64, cfg, images.double())
    loss = (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels.long()[:, None])[:, 0]).mean()
    grads = torch.autograd.grad(loss, list(p64.values()))
    eta = tr.tr.cfg.eta
    d64 = convert.params_to_jax({k: (x - eta * g) - x for (k, x), g in
                                 zip(p64.items(), grads)}, cfg)
    d64 = {k: np.asarray(x.detach() if torch.is_tensor(x) else x,
                         np.float64) for k, x in d64.items()}
    return v, d_ref, d_port, d64


def l2(d):
    return float(np.sqrt(sum(float((x * x).sum()) for x in d.values())))


def l2_diff(a, b):
    return l2({k: a[k] - b[k] for k in a})


@pytest.mark.parametrize("backend", BACKENDS)
def test_explode_1e6_gs_holds_what_can_be_held(micro_world, backend):
    """GS at ``corrupt_scale=1e6`` (the module docstring): the records and
    params through round 2 at the contract, the fault draws of all six
    rounds bitwise; in round 3, the first to differ, the same devices
    upload in both and every integer of the record is equal; one
    upload's raw delta is rounding residue (a norm below 1e-4 of the
    other upload's) in both packages, and each package's f32 delta lies
    at least 5 % (in L2) from the f64 one, no closer to it than to the
    other package's; every round finite."""
    jr, tr = pair(micro_world, backend, "fedcgd-gs", **explode(1e6))
    run_pair(jr, tr, 3)
    rj, rt = jr.tr.run_round(3), tr.tr.run_round(3)
    assert all(rj[k] == rt[k] for k in rj if not isinstance(rj[k], float))
    mj, mt = jr.decisions[-1][0], tr.decisions[-1][0]
    np.testing.assert_array_equal(mj, mt)
    assert mj.sum() == 2
    for rec in (jr, tr):
        up = np.sort(rec.norms[-1][mj])
        assert up[0] < 1e-4 * up[1], up
    _, d_ref, d_port, d64 = round3_deltas(jr, tr)
    apart = l2_diff(d_ref, d_port)
    for d in (d_ref, d_port):
        off = l2_diff(d, d64)
        assert off >= 0.05 * l2(d64) and off >= 0.25 * apart, (off, apart)
    for j in (4, 5):
        jr.tr.run_round(j)
        tr.tr.run_round(j)
    assert_same_draws(jr, tr)
    assert params_finite(tr.tr)
    assert all(np.isfinite(h["g_hat"]) and np.isfinite(h["sigma_hat"])
               for h in tr.tr.history)


@pytest.mark.parametrize("backend", BACKENDS)
def test_g_refresh_error_counter_matches_reference(micro_world, backend,
                                                   monkeypatch):
    """A failing Eq. 12 refresh is skipped and counted, in each package
    alike; an unexpected exception type still propagates."""
    def boom(*a, **k):
        raise ValueError("synthetic Eq. 12 failure")
    monkeypatch.setattr(JE, "g_hat", boom)
    monkeypatch.setattr(TE, "g_hat", boom)
    jr, tr = pair(micro_world, backend)
    hist = run_pair(jr, tr, 2)
    assert all(h["g_refresh_errors"] == 1 for h in hist)
    assert tr.tr.g_refresh_errors == 2 == jr.tr.g_refresh_errors

    def boom2(*a, **k):
        raise RuntimeError("must propagate")
    monkeypatch.setattr(TE, "g_hat", boom2)
    with pytest.raises(RuntimeError):
        tr.tr.run_round(2)


def test_cli_lossy_and_metrics_out(tmp_path, capsys):
    """``--lossy`` arms the reference example's fault mix and
    ``--metrics-out`` streams one JSON record a round."""
    from repro_torch.cli import main
    from repro_torch.obs import read_jsonl
    path = tmp_path / "m.jsonl"
    main(["--device", "cpu", "--backend", "torch", "--rounds", "3",
          "--devices", "8", "--classes", "3", "--available-prob", "0.8",
          "--lossy", "--metrics-out", str(path)])
    out = capsys.readouterr().out
    assert "-- failure telemetry --" in out
    assert "observability summary" in out
    rows = [r for r in read_jsonl(str(path)) if r.get("kind") == "round"]
    assert [r["round"] for r in rows] == [0, 1, 2]


def drift_report(rounds=6):
    """The GS / ``corrupt_scale=1e6`` drift, measured (numpy backend):
    round 3's diverging delta in each package and in f64, G-hat of each
    round, the first round whose integers differ, and the params' largest
    difference after ``rounds`` rounds, as a share of each leaf's largest
    entry; then the reference against itself with its round-3 params
    moved by one ulp (each entry up or down, from a seeded draw)."""
    import jax.numpy as jnp

    from repro.configs.paper_cnn import CNNConfig as JCNNConfig
    from repro.data import (sort_and_partition, synthetic_image_dataset,
                            train_test_split)
    from repro.models import build_model as j_build
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.models.registry import build_model
    from test_torch_round import MICRO
    ds = synthetic_image_dataset(num_classes=2, num_per_class=40,
                                 image_size=8, seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 8, 1, np.random.default_rng(0))
    world = (j_build(JCNNConfig(**MICRO)), build_model(CNNConfig(**MICRO)),
             train, test, parts)
    jr, tr = pair(world, "numpy", "fedcgd-gs", **explode(1e6))
    lines, split = [], None
    for j in range(rounds):
        rj, rt = jr.tr.run_round(j), tr.tr.run_round(j)
        lines.append(f"round {j}: g_hat {rj['g_hat']:.6f} / "
                     f"{rt['g_hat']:.6f} ({abs(rj['g_hat'] - rt['g_hat']) / rj['g_hat']:.3g} relative)")
        if split is None and any(rj[k] != rt[k] for k in rj
                                 if not isinstance(rj[k], float)):
            split = (j, {k: (rj[k], rt[k]) for k in rj if not isinstance(
                rj[k], float) and rj[k] != rt[k]})
        if j == 3:
            v, d_ref, d_port, d64 = round3_deltas(jr, tr)
            lines.append(
                f"round 3, device {v}: raw delta norm reference "
                f"{l2(d_ref):.6g}, port {l2(d_port):.6g}, f64 "
                f"{l2(d64):.6g}; apart in L2 over the f64 norm: reference "
                f"{l2_diff(d_ref, d64) / l2(d64):.4f}, port "
                f"{l2_diff(d_port, d64) / l2(d64):.4f}, reference vs port "
                f"{l2_diff(d_ref, d_port) / l2(d64):.4f}")
    lines.append(f"first round whose integers differ: {split}")
    back = convert.params_to_jax(tr.tr.params, tr.tr.model.cfg)
    worst = max(float(np.abs(np.asarray(back[k]) - np.asarray(x)).max()
                      / np.abs(np.asarray(x)).max())
                for k, x in jr.tr.params.items())
    lines.append(f"after {rounds} rounds the params differ by up to "
                 f"{worst:.4f} of a leaf's largest entry")
    a, b = (pair(world, "numpy", "fedcgd-gs", **explode(1e6))[0]
            for _ in range(2))
    for j in range(3):
        a.tr.run_round(j)
        b.tr.run_round(j)
    rng = np.random.default_rng(0)
    b.tr.params = {k: jnp.asarray(np.nextafter(np.asarray(x), np.where(
        rng.random(x.shape) < 0.5, np.inf, -np.inf).astype(np.float32)))
        for k, x in b.tr.params.items()}
    ra, rb = a.tr.run_round(3), b.tr.run_round(3)
    up = np.flatnonzero(a.decisions[-1][0])
    lines.append(
        f"the reference with its round-3 params moved one ulp: g_hat "
        f"{ra['g_hat']:.6f} / {rb['g_hat']:.6f}; the uploads' raw delta "
        f"norms {a.norms[-1][up]} / {b.norms[-1][up]}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(drift_report())
