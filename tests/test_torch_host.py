"""The port's framework-free host modules equal the reference's bitwise
on equal seeds: channel draws, Eq. 9 bandwidths, partitions, the
synthetic datasets, WEMD, fault draws and the metrics registry."""
import numpy as np
import pytest

from repro.core import bandwidth as RB
from repro.core import wemd as RW
from repro.data import datasets as RD
from repro.data import partition as RP
from repro.faults import FaultConfig as RFaultConfig
from repro.faults import FaultInjector as RFaultInjector
from repro.obs import metrics as RM
from repro.obs import sinks as RSinks
from repro.wireless import channel as RC
from repro_torch.core import bandwidth as TB
from repro_torch.core import wemd as TW
from repro_torch.data import datasets as TD
from repro_torch.data import partition as TP
from repro_torch.faults import FaultConfig as TFaultConfig
from repro_torch.faults import FaultInjector as TFaultInjector
from repro_torch.obs import metrics as TM
from repro_torch.obs import sinks as TSinks
from repro_torch.wireless import channel as TC


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("seed", [0, 7])
def test_channel_draws_bitwise(seed):
    rc = RC.make_cell(64, np.random.default_rng(seed))
    tc = TC.make_cell(64, np.random.default_rng(seed))
    for f in ("positions", "d2d", "d3d"):
        same(getattr(rc, f), getattr(tc, f))
    r1, r2 = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    for _ in range(3):
        g1, g2 = rc.draw_gains(r1), tc.draw_gains(r2)
        same(g1, g2)
        same(rc.received_power(g1), tc.received_power(g2))
    cells_r = [RC.make_cell(16, np.random.default_rng(s)) for s in range(3)]
    cells_t = [TC.make_cell(16, np.random.default_rng(s)) for s in range(3)]
    gr = RC.draw_gains_batch(cells_r, [np.random.default_rng(s)
                                       for s in range(3)])
    gt = TC.draw_gains_batch(cells_t, [np.random.default_rng(s)
                                       for s in range(3)])
    same(gr, gt)
    same(RC.received_power_batch(cells_r, gr),
         TC.received_power_batch(cells_t, gt))
    shadow = np.random.default_rng(seed).normal(0, 4, 64)
    same(RC.apply_shadow_db(g1, shadow), TC.apply_shadow_db(g2, shadow))
    d = np.linspace(0, 300, 50)
    same(RC.los_probability(d), TC.los_probability(d))
    same(RC.path_loss_db(d, 3.5, d < 100), TC.path_loss_db(d, 3.5, d < 100))


def test_min_bandwidth_eq9_bitwise():
    rng = np.random.default_rng(3)
    cell = RC.make_cell(64, rng)
    sh = cell.received_power(cell.draw_gains(rng))
    noise = cell.params.noise_psd_w
    for bits in (1e5, 2.5e6, 4e7):
        b_r = RB.min_bandwidth(bits, 2.0, sh, noise)
        b_t = TB.min_bandwidth(bits, 2.0, sh, noise)
        same(b_r, b_t)
        assert (b_t < 0).any() or bits < 4e7
        same(RB.deadline_met(b_r, bits, 2.0, sh, noise, slack=0.1),
             TB.deadline_met(b_t, bits, 2.0, sh, noise, slack=0.1))
    same(RB.uplink_rate(1e6, sh, noise), TB.uplink_rate(1e6, sh, noise))
    assert RB.min_bandwidth_bisect(1e6, 2.0, float(sh[0]), noise) == \
        TB.min_bandwidth_bisect(1e6, 2.0, float(sh[0]), noise)


def test_partitions_bitwise():
    labels = np.random.default_rng(0).integers(0, 10, 2000)
    for l in (1, 2):
        a = RP.sort_and_partition(labels, 32, l, np.random.default_rng(1))
        b = TP.sort_and_partition(labels, 32, l, np.random.default_rng(1))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    a = RP.dirichlet_partition(labels, 16, 0.5, np.random.default_rng(2))
    b = TP.dirichlet_partition(labels, 16, 0.5, np.random.default_rng(2))
    for x, y in zip(a, b):
        same(x, y)
    same(RP.apply_imbalance(labels, 3.0, np.random.default_rng(4)),
         TP.apply_imbalance(labels, 3.0, np.random.default_rng(4)))
    same(RP.label_distributions(labels, a, 10),
         TP.label_distributions(labels, b, 10))
    same(RP.global_distribution(labels, a, 10),
         TP.global_distribution(labels, b, 10))


def test_synthetic_datasets_bitwise():
    a = RD.synthetic_image_dataset(num_classes=4, num_per_class=20,
                                   image_size=8, seed=5)
    b = TD.synthetic_image_dataset(num_classes=4, num_per_class=20,
                                   image_size=8, seed=5)
    same(a.inputs, b.inputs)
    same(a.labels, b.labels)
    ta, ea = RD.train_test_split(a, seed=1)
    tb, eb = TD.train_test_split(b, seed=1)
    same(ta.inputs, tb.inputs)
    same(eb.labels, ea.labels)
    xa, ya = RD.sample_batch(a, np.arange(30), 8, np.random.default_rng(0))
    xb, yb = TD.sample_batch(b, np.arange(30), 8, np.random.default_rng(0))
    same(xa, xb)
    same(ya, yb)
    tok_a = RD.synthetic_token_dataset(64, 12, num_classes=4, seed=2)
    tok_b = TD.synthetic_token_dataset(64, 12, num_classes=4, seed=2)
    same(tok_a.inputs, tok_b.inputs)


def test_wemd_bitwise_and_candidates():
    rng = np.random.default_rng(11)
    C, V = 10, 23
    p_dev = rng.dirichlet(np.full(C, 0.4), size=V)
    gd = rng.dirichlet(np.full(C, 3.0))
    cw = rng.uniform(0.5, 1.5, C)
    mask = rng.random(V) < 0.4
    assert RW.wemd_of_set(p_dev, mask, gd, cw) == \
        TW.wemd_of_set(p_dev, mask, gd, cw)
    assert RW.p1_objective(mask, p_dev, gd, cw, 3.0, 32) == \
        TW.p1_objective(mask, p_dev, gd, cw, 3.0, 32)
    same(RW.group_distribution(p_dev, mask),
         TW.group_distribution(p_dev, mask))
    p_sum = p_dev[mask].sum(0)
    s = int(mask.sum())
    # the candidate sums run over classes in a fixed order (ties between
    # equal devices must not depend on a row's position): equal to the
    # reference's BLAS sums up to rounding
    np.testing.assert_allclose(
        TW.wemd_add_candidates(p_sum, s, p_dev, gd, cw),
        RW.wemd_add_candidates(p_sum, s, p_dev, gd, cw), rtol=1e-13)
    i_in, i_out = np.flatnonzero(mask), np.flatnonzero(~mask)
    np.testing.assert_allclose(
        TW.wemd_swap_candidates(p_sum, s, p_dev, i_in, i_out, gd, cw),
        RW.wemd_swap_candidates(p_sum, s, p_dev, i_in, i_out, gd, cw),
        rtol=1e-13)


def test_wemd_candidates_tie_equal_devices_exactly():
    """Devices with equal label histograms get bitwise-equal candidate
    values wherever they sit, so argmin breaks the tie by index."""
    rng = np.random.default_rng(12)
    C = 10
    rows = rng.dirichlet(np.full(C, 0.4), size=5)
    p_dev = rows[rng.integers(0, 5, 40)]
    gd, cw = rows.mean(0), np.full(C, 146.7)
    w = TW.wemd_add_candidates(rows[0] * 3, 3, p_dev, gd, cw)
    for r in rows:
        eq = np.flatnonzero((p_dev == r).all(1))
        assert len(set(w[eq].tolist())) == 1


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(outage_prob=0.3, dropout_prob=0.2, deadline_miss_prob=0.1,
         corrupt_prob=0.2, reshadow_std_db=4.0, outage_slack=0.2, seed=3),
])
def test_fault_draws_bitwise(cfg):
    rinj = RFaultInjector(RFaultConfig(**cfg), 32, base_seed=5)
    tinj = TFaultInjector(TFaultConfig(**cfg), 32, base_seed=5)
    rng = np.random.default_rng(0)
    cell = RC.make_cell(32, rng)
    gains = cell.draw_gains(rng)
    sched = rng.random(32) < 0.5
    bstar = RB.min_bandwidth(1e6, 2.0, cell.received_power(gains),
                             cell.params.noise_psd_w)
    for j in range(4):
        rf, tf = rinj.draw(j), tinj.draw(j)
        for f in ("dropout", "deadline_miss", "outage", "reshadow_db",
                  "corrupt", "corrupt_mode"):
            same(getattr(rf, f), getattr(tf, f))
        ug = tinj.upload_gains(gains, tf)
        same(rinj.upload_gains(gains, rf), ug)
        args = (sched, bstar, 1e6, 2.0, cell.received_power(ug),
                cell.params.noise_psd_w)
        same(rinj.arrival_failures(rf, *args),
             tinj.arrival_failures(tf, *args))
    with pytest.raises(ValueError):
        TFaultConfig(outage_prob=1.5)


def test_metrics_registry_and_summary_match():
    regs = (RM.Registry(), TM.Registry())
    vals = np.random.default_rng(0).lognormal(-6, 2, 200)
    for reg in regs:
        for v in vals:
            reg.histogram("span.core").observe(v)
        reg.counter("fl.rounds_total").inc(3)
        reg.gauge("fl.g_hat").set(2.5)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert RSinks.format_summary(regs[0]) == TSinks.format_summary(regs[1])
