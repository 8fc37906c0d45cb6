"""FederatedTrainer: the port against the reference on the dropout-free
micro world of ``tests/test_multicell.py``.

The reference runs ``scheduler_backend="numpy"`` (its jax backend does
not import on this toolchain); the port runs ``"numpy"`` and
``"torch"`` (the batched engine, CPU route).  Both start from the same
params (converted), so host draws are bitwise equal and device float
math agrees to f32 tolerance.  The determinism cases hold the port to
itself (on the CPU, and on the card where there is one)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as JCNNConfig
from repro.data import (sort_and_partition, synthetic_image_dataset,
                        train_test_split)
from repro.fl import FederatedTrainer as JTrainer
from repro.fl import FLConfig as JFLConfig
from repro.models import build_model as j_build
from repro_torch import convert
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.faults import FaultConfig
from repro_torch.fl import FederatedTrainer, FLConfig
from repro_torch.models.registry import build_model
from repro_torch.obs import ObsConfig

ATOL, RTOL = 1e-4, 1e-3
MICRO = dict(name="micro-cnn", kind="paper_cnn", num_classes=2,
             image_size=8, dropout=False, width=0.25)


@pytest.fixture(scope="module")
def micro_world():
    ds = synthetic_image_dataset(num_classes=2, num_per_class=40,
                                 image_size=8, seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 8, 1,
                               np.random.default_rng(0))
    return (j_build(JCNNConfig(**MICRO)), build_model(CNNConfig(**MICRO)),
            train, test, parts)


def common_cfg(scheduler="fedcgd-fscd", **kw):
    return dict(num_devices=8, available_prob=0.7, batch_size=2, tau=1,
                eval_every=2, seed=0, scheduler=scheduler, **kw)


def pair(world, scheduler, backend, **port_kw):
    jm, tm, train, test, parts = world
    jt = JTrainer(jm, train, test, parts,
                  JFLConfig(scheduler_backend="numpy",
                            **common_cfg(scheduler)))
    tt = FederatedTrainer(tm, train, test, parts,
                          FLConfig(scheduler_backend=backend, device="cpu",
                                   **common_cfg(scheduler), **port_kw))
    tt.params = convert.params_from_jax(
        {k: np.asarray(v) for k, v in jt.params.items()}, tm.cfg,
        device="cpu")
    return jt, tt


def assert_records(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float):
            assert np.isclose(a[k], b[k], atol=ATOL, rtol=RTOL), (k, a, b)
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def assert_params(jp, tp, cfg):
    back = convert.params_to_jax(tp, cfg)
    for k in jp:
        np.testing.assert_allclose(back[k], np.asarray(jp[k]), atol=ATOL,
                                   rtol=RTOL)


def stacked_to_torch(tree, cfg):
    """[V, ...] JAX params -> [V, ...] port params."""
    V = next(iter(tree.values())).shape[0]
    per = [convert.params_from_jax({k: np.asarray(x[v])
                                    for k, x in tree.items()}, cfg,
                                   device="cpu") for v in range(V)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("scheduler", ["fedcgd-fscd", "fedcgd-gs"])
def test_five_rounds_match_reference(micro_world, scheduler, backend):
    jt, tt = pair(micro_world, scheduler, backend)
    for j in range(5):
        assert_records(jt.run_round(j), tt.run_round(j))
        assert tt.last_round_host_syncs == 2 == jt.last_round_host_syncs
    assert_params(jt.params, tt.params, tt.model.cfg)
    assert tt.g_hat > 0 and np.isfinite(tt.sigma_hat)


@pytest.mark.parametrize("scheduler", ["fedcgd-fscd", "fedcgd-gs"])
def test_round_phases_match_reference(micro_world, scheduler):
    """The same core outputs go into both schedulers and both finalizes;
    the port's own core matches the reference core."""
    jt, tt = pair(micro_world, scheduler, "torch")
    cfg = tt.model.cfg
    for j in range(2):
        pj, pt = jt._prepare_round(j), tt._prepare_round(j)
        np.testing.assert_array_equal(pj.avail, pt.avail)
        np.testing.assert_array_equal(pj.bstar, pt.bstar)
        np.testing.assert_array_equal(pj.p_sampled, pt.p_sampled)
        np.testing.assert_array_equal(np.asarray(pj.batches["images"]),
                                      pt.batches["images"].numpy())
        # core
        out_j = jt._round_core(jax.tree.map(lambda x: x[None], jt.params),
                               jax.tree.map(lambda x: x[None], pj.batches),
                               jnp.stack([pj.subkey]))
        dev_j, loss_j, sig_j, delta_j, norm_j, fin_j = (
            jax.tree.map(lambda x: x[0], o) for o in out_j)
        out_t = tt._round_core({k: x[None] for k, x in tt.params.items()},
                               {k: x[None] for k, x in pt.batches.items()},
                               ())
        for a, b in zip((loss_j, sig_j, norm_j),
                        (out_t[1], out_t[2], out_t[4])):
            np.testing.assert_allclose(b[0].numpy(), np.asarray(a),
                                       atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(out_t[5][0].numpy(),
                                      np.asarray(fin_j))
        # schedule, from the reference's core outputs
        losses = np.asarray(loss_j, np.float64)
        sigma = np.asarray(sig_j, np.float64)
        norms = np.asarray(norm_j, np.float64)
        jt._post_core(pj, losses, sigma)
        tt._post_core(pt, losses, sigma)
        assert jt.sigma_hat == tt.sigma_hat
        prob_j, prob_t = jt._make_problem(pj), tt._make_problem(pt)
        sj = jt._schedule(prob_j, pj.avail_idx, pj.gains, norms, j)
        st_ = tt._schedule(prob_t, pt.avail_idx, pt.gains, norms, j)
        np.testing.assert_array_equal(sj.mask, st_.mask)
        assert sj.iterations == st_.iterations
        # upload + finalize, from the reference's device params and deltas
        fin = np.asarray(fin_j)
        up_j = jt._upload_phase(j, pj, sj, delta_j, norms, finite=fin)
        up_t = tt._upload_phase(j, pt, st_, stacked_to_torch(delta_j, cfg),
                                norms, finite=fin)
        np.testing.assert_array_equal(up_j.upload, up_t.upload)
        rj = jt._finalize_round(j, pj, sj, up_j, dev_j, delta_j, losses)
        rt = tt._finalize_round(j, pt, st_, up_t,
                                stacked_to_torch(dev_j, cfg),
                                stacked_to_torch(delta_j, cfg), losses)
        assert_records(rj, rt)
        assert_params(jt.params, tt.params, cfg)


def test_single_upload_norm_is_exactly_zero():
    """Finalize centers raw deltas before scaling: one upload gives a
    norm of exactly 0 (so the g > 0 refresh guard skips it)."""
    from repro_torch.fl.server import make_finalize_core
    core = make_finalize_core(tau=3, eta=0.07)
    rng = np.random.default_rng(0)
    deltas = {"w": torch.from_numpy(rng.normal(size=(1, 4, 5, 3))
                                    .astype(np.float32))}
    params = {"w": torch.zeros(1, 5, 3)}
    w = torch.tensor([[0.0, 1.0, 0.0, 0.0]])
    newp, norms = core(params, deltas, deltas, w, [True])
    assert float(norms[0, 1]) == 0.0
    torch.testing.assert_close(newp["w"][0], deltas["w"][0, 1])
    same, _ = core(params, deltas, deltas, w, [False])
    assert torch.equal(same["w"], params["w"])


def test_obs_records_and_sync_contract(micro_world):
    _, tm, train, test, parts = micro_world
    tt = FederatedTrainer(tm, train, test, parts, FLConfig(
        scheduler_backend="torch", device="cpu",
        obs=ObsConfig(enabled=True, ring_size=8), **common_cfg()))
    tt.run(3)
    recs = tt.obs.records()
    assert [r["round"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert r["host_syncs"] == 2
        assert set(r["phases"]) == {"prep", "core", "schedule", "upload",
                                    "finalize"}
        assert sum(r["phases"].values()) <= r["round_s"]
    c = tt.obs.metrics.counters
    assert c["calls.round_core"].value == 3
    assert c["sched.solve_many_calls.torch"].value == 3


def test_dropout_and_faults_run(micro_world):
    """Dropout masks from the trainer's generator, and a lossy round
    loop (outages, corruption, clipping, backfill) on the port."""
    _, _, train, test, parts = micro_world
    tm = build_model(CNNConfig(**dict(MICRO, dropout=True)))
    faults = FaultConfig(outage_prob=0.3, corrupt_prob=0.3,
                         clip_delta_norm=0.5, reshadow_std_db=4.0, seed=1)
    tt = FederatedTrainer(tm, train, test, parts, FLConfig(
        scheduler_backend="torch", device="cpu", faults=faults,
        **common_cfg()))
    hist = tt.run(4)
    assert all(np.isfinite(h["mean_local_loss"]) for h in hist)
    assert sum(h["num_failed"] + h["num_sanitized"] for h in hist) > 0
    assert all(bool(torch.isfinite(p).all()) for p in tt.params.values())


def test_cli_runs_on_cpu(capsys):
    from repro_torch.cli import main
    main(["--device", "cpu", "--backend", "torch", "--rounds", "2",
          "--devices", "6", "--classes", "3"])
    out = capsys.readouterr().out
    assert "== fedcgd-fscd on cpu ==" in out


@pytest.fixture(scope="module")
def port_world():
    """The micro world's data, from the port's own data helpers."""
    from repro_torch.data import (sort_and_partition, synthetic_image_dataset,
                                  train_test_split)
    ds = synthetic_image_dataset(num_classes=2, num_per_class=40,
                                 image_size=8, seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 8, 1,
                               np.random.default_rng(0))
    return train, test, parts


@pytest.fixture(params=["cpu", pytest.param(
    "cuda", marks=pytest.mark.requires_cuda)])
def fl_device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return request.param


class RecordingTrainer(FederatedTrainer):
    """Keeps every round's mask and iteration count, and the per-device
    losses and Eq. 10 sigmas of its round core."""

    def _schedule(self, prob, *a):
        sched = super()._schedule(prob, *a)
        self.decisions.append((sched.mask.copy(), sched.iterations))
        return sched

    def _post_core(self, prep, dev_losses, sigma_v):
        self.core_out.append((dev_losses.copy(), sigma_v.copy()))
        super()._post_core(prep, dev_losses, sigma_v)


@pytest.mark.parametrize("dropout", [False, True])
def test_same_seed_gives_bitwise_equal_rounds(port_world, fl_device,
                                              dropout):
    """Two trainers on one seed: bitwise-equal history, masks, iteration
    counts, losses, sigmas and params after 3 rounds (the reference's
    ``test_fault_determinism_across_runs`` contract).  With dropout the
    keep masks come from the trainer's generator on the device."""
    train, test, parts = port_world
    model = build_model(CNNConfig(**dict(MICRO, dropout=dropout)))
    runs = []
    for _ in range(2):
        tr = RecordingTrainer(model, train, test, parts, FLConfig(
            scheduler_backend="torch", device=fl_device, **common_cfg()))
        tr.decisions, tr.core_out = [], []
        runs.append((tr.run(3), tr.decisions, tr.core_out, tr.params))
    (h1, d1, c1, p1), (h2, d2, c2, p2) = runs
    assert len(h1) == len(d1) == len(c1) == 3
    assert h1 == h2
    for (m1, i1), (m2, i2) in zip(d1, d2):
        np.testing.assert_array_equal(m1, m2)
        assert i1 == i2
    for (l1, s1), (l2, s2) in zip(c1, c2):
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(s1, s2)
    assert p1.keys() == p2.keys()
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
