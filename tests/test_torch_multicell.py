"""MultiCellTrainer: the port against the reference's multi-cell engine
on the dropout-free micro world of ``tests/test_multicell.py``, and
against its own single-cell trainer.

The reference runs ``scheduler_backend="numpy"`` (its jax backend does
not import on this toolchain); both engines start from the same stacked
cell params (converted by ``convert.cell_params_from_jax``), so host
draws, masks and iteration counts are bitwise equal and device float
math agrees to f32 tolerance (atol 1e-4, rtol 1e-3, as
``tests/test_torch_round.py``).  The port against itself: C=1 equals
``FederatedTrainer`` bitwise, and with full availability every cell of a
C=3 run equals a standalone trainer bitwise."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as JCNNConfig
from repro.data import (sort_and_partition, synthetic_image_dataset,
                        train_test_split)
from repro.faults.config import FaultConfig as JFaultConfig
from repro.fl import FLConfig as JFLConfig
from repro.fl import MultiCellTrainer as JMultiCell
from repro.models import build_model as j_build
from repro_torch import convert
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core import scheduling as S
from repro_torch.faults import FaultConfig
from repro_torch.fl import FederatedTrainer, FLConfig, MultiCellTrainer
from repro_torch.fl.client import make_round_core
from repro_torch.fl.multicell import _pad_problems
from repro_torch.fl.server import make_finalize_core
from repro_torch.models.registry import build_model
from repro_torch.obs import ObsConfig

ATOL, RTOL = 1e-4, 1e-3
MICRO = dict(name="micro-cnn", kind="paper_cnn", num_classes=2,
             image_size=8, dropout=False, width=0.25)


@pytest.fixture(scope="module")
def world():
    ds = synthetic_image_dataset(num_classes=2, num_per_class=40,
                                 image_size=8, seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 8, 1,
                               np.random.default_rng(0))
    return (j_build(JCNNConfig(**MICRO)), build_model(CNNConfig(**MICRO)),
            train, test, parts)


def cfg_kw(cells=1, seed=0, avail=0.7, scheduler="fedcgd-fscd", **kw):
    return dict(num_devices=8, available_prob=avail, batch_size=2, tau=1,
                eval_every=2, seed=seed, num_cells=cells,
                scheduler=scheduler, **kw)


def port_cfg(backend="torch", device="cpu", **kw):
    return FLConfig(scheduler_backend=backend, device=device, **cfg_kw(**kw))


def port_engine(world, **kw):
    _, tm, train, test, parts = world
    return MultiCellTrainer(tm, train, test, parts, port_cfg(**kw))


def load_params(mc, params_c):
    """Set the engine's stacked params and its cells' views."""
    mc._params_c = params_c
    for c, cell in enumerate(mc.cells):
        cell.params = {k: x[c] for k, x in params_c.items()}


def reference_pair(world, backend="torch", faults=None, **kw):
    """(reference engine, port engine) from the reference's init."""
    jm, tm, train, test, parts = world
    jkw = {} if faults is None else {"faults": JFaultConfig(**faults)}
    pkw = {} if faults is None else {"faults": FaultConfig(**faults)}
    jmc = JMultiCell(jm, train, test, parts,
                     JFLConfig(scheduler_backend="numpy", **cfg_kw(**kw),
                               **jkw))
    mc = port_engine(world, backend=backend, **kw, **pkw)
    load_params(mc, convert.cell_params_from_jax(
        {k: np.asarray(v) for k, v in jmc._params_c.items()}, tm.cfg,
        device="cpu"))
    return jmc, mc


def assert_records(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float):
            assert np.isclose(a[k], b[k], atol=ATOL, rtol=RTOL), (k, a, b)
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def assert_params_close(jparams_c, params_c, cfg):
    C = next(iter(params_c.values())).shape[0]
    for c in range(C):
        back = convert.params_to_jax({k: x[c] for k, x in params_c.items()},
                                     cfg)
        for k in back:
            np.testing.assert_allclose(back[k], np.asarray(jparams_c[k][c]),
                                       atol=ATOL, rtol=RTOL)


def assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# against the reference


@pytest.mark.parametrize("scheduler", ["fedcgd-fscd", "fedcgd-gs"])
def test_three_cells_match_reference(world, scheduler):
    jmc, mc = reference_pair(world, cells=3, scheduler=scheduler)
    for j in range(5):
        for a, b in zip(jmc.run_round(j), mc.run_round(j)):
            assert_records(a, b)
        assert mc.last_round_host_syncs == 2 == jmc.last_round_host_syncs
    assert mc.solve_many_calls == 5 == jmc.solve_many_calls
    assert_params_close(jmc._params_c, mc._params_c, mc.cells[0].model.cfg)
    for c, cell in enumerate(mc.cells):
        assert cell.params["c1"].data_ptr() == mc._params_c["c1"][c] \
            .data_ptr()                     # a view of the stack


def test_faulty_rounds_with_backfill_match_reference(world):
    jmc, mc = reference_pair(world, backend="numpy", cells=3,
                             faults=dict(outage_prob=0.4, backfill=True))
    rounds = 4
    for j in range(rounds):
        jrecs, recs = jmc.run_round(j), mc.run_round(j)
        for a, b in zip(jrecs, recs):
            assert_records(a, b)        # fault draws + failure telemetry
        for jc, cell in zip(jmc.cells, mc.cells):
            jf, tf = jc.faults.draw(j), cell.faults.draw(j)
            for field in ("dropout", "deadline_miss", "outage",
                          "reshadow_db", "corrupt", "corrupt_mode"):
                np.testing.assert_array_equal(getattr(jf, field),
                                              getattr(tf, field))
    assert rounds <= mc.solve_many_calls == jmc.solve_many_calls \
        <= 2 * rounds
    assert sum(r["num_failed"] for recs in mc.history for r in recs) > 0
    assert sum(r["num_backfilled"] for recs in mc.history for r in recs) > 0


# ---------------------------------------------------------------------------
# against the port's own single-cell trainer


@pytest.fixture(params=["cpu", pytest.param(
    "cuda", marks=pytest.mark.requires_cuda)])
def fl_device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return request.param


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_one_cell_equals_federated_trainer_bitwise(world, fl_device,
                                                   backend):
    _, tm, train, test, parts = world
    cfg = port_cfg(backend=backend, device=fl_device)
    ref = FederatedTrainer(tm, train, test, parts, cfg)
    mc = MultiCellTrainer(tm, train, test, parts, cfg)
    for j in range(3 if fl_device == "cuda" else 5):
        rec_ref = ref.run_round(j)
        rec_mc, = mc.run_round(j)
        assert rec_ref == rec_mc
        assert mc.last_round_host_syncs == 2 == ref.last_round_host_syncs
    assert_params_equal(ref.params, mc.cells[0].params)


def test_full_availability_cells_equal_standalone_trainers(world,
                                                           fl_device):
    """No padding: every cell equals a standalone trainer bitwise (each
    device's Eq. 10 sigma depends on its own rows only, in one launch for
    all cells as in one a cell)."""
    _, tm, train, test, parts = world
    mc = port_engine(world, cells=3, avail=1.0, device=fl_device)
    mc.run(4)
    for c in range(3):
        ref = FederatedTrainer(tm, train, test, parts,
                               port_cfg(seed=c, avail=1.0,
                                        device=fl_device))
        ref.run(4)
        assert [r[c] for r in mc.history] == ref.history
        assert_params_equal(ref.params, mc.cells[c].params)


def test_cells_evolve_independently_and_replay(world, fl_device):
    """Distinct seeds give distinct trajectories; two engines on one seed
    give a bitwise-equal history and params."""
    runs = [port_engine(world, cells=2, device=fl_device)
            for _ in range(2)]
    for mc in runs:
        mc.run(3)
    a, b = runs
    assert a.history == b.history
    assert_params_equal(a._params_c, b._params_c)
    assert not torch.equal(a.cells[0].params["fc2"], a.cells[1].params["fc2"])
    assert a.history[0][0]["mean_local_loss"] \
        != a.history[0][1]["mean_local_loss"]


def test_padding_never_surfaces(world, monkeypatch):
    """Cells with fewer available devices run padded; the padded rows are
    never scheduled, and no mask or record shows them."""
    mc = port_engine(world, cells=3, avail=0.5)
    seen = []
    real = mc._solve_batch

    def checked(probs):
        scheds = real(probs)
        vmax = max(p.num_devices for p in probs)
        for p, s in zip(probs, scheds):
            assert len(s.mask) == vmax
            assert not s.mask[p.num_devices:].any()
            seen.append(vmax - p.num_devices)
        return scheds

    monkeypatch.setattr(mc, "_solve_batch", checked)
    for recs in mc.run(4):
        for rec in recs:
            assert rec["num_scheduled"] <= rec["num_available"]
            assert rec["num_uploaded"] <= rec["num_available"]
            assert np.isfinite(rec["mean_local_loss"])
    assert max(seen) > 0                # some round was padded


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("algorithm", ["gs", "fscd"])
def test_padded_problems_solve_as_unpadded(algorithm, backend):
    """A zero-distribution, infeasible (min_bw = -1) row changes no
    decision and no iteration count of either port backend."""
    rng = np.random.default_rng(7)
    probs = []
    for V in (5, 9, 12):
        probs.append(S.Problem(
            p_dev=rng.dirichlet(np.full(4, 0.4), size=V),
            global_dist=np.full(4, 0.25), class_weights=np.ones(4),
            sigma=3.0, batch_size=8, min_bw=rng.uniform(0.4, 1.6, V),
            total_bw=V * 0.5))
    padded = S.solve_many(_pad_problems(probs), algorithm, backend=backend,
                          device="cpu")
    for p, got in zip(probs, padded):
        want = S.solve_many([p], algorithm, backend=backend,
                            device="cpu")[0]
        np.testing.assert_array_equal(got.mask[:p.num_devices], want.mask)
        assert not got.mask[p.num_devices:].any()
        assert got.iterations == want.iterations
        assert got.objective == want.objective


@pytest.mark.parametrize("cells", [1, 2, 4])
def test_one_solve_many_and_two_host_syncs_per_round(world, monkeypatch,
                                                     cells):
    mc = port_engine(world, cells=cells)
    calls = []
    real = S.solve_many
    monkeypatch.setattr(S, "solve_many",
                        lambda *a, **k: calls.append(len(a[0])) or
                        real(*a, **k))
    for j in range(3):
        mc.run_round(j)
        assert mc.last_round_host_syncs == 2
    assert mc.solve_many_calls == 3
    assert calls == [cells] * 3     # one batched call of C problems


def test_obs_records_phases_and_syncs(world):
    mc = port_engine(world, cells=2, obs=ObsConfig(enabled=True,
                                                   ring_size=16))
    mc.run(2)
    recs = mc.obs.records()
    engine = [r for r in recs if r["kind"] == "multicell_round"]
    assert [r["round"] for r in engine] == [0, 1]
    for r in engine:
        assert r["cells"] == 2 and r["host_syncs"] == 2
        assert set(r["phases"]) == {"prep", "core", "schedule", "upload",
                                    "finalize"}
    assert sorted((r["round"], r["cell"]) for r in recs
                  if r["kind"] == "round") == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    assert mc.obs.metrics.counters["fl.rounds_total"].value == 2
    # round 0 evaluates each of the 2 cells (eval_every=2)
    assert mc.obs.metrics.histograms["span.eval"].count == 2


# ---------------------------------------------------------------------------
# the cores over a cell axis


def test_round_core_cells_equal_single_cell_calls(world):
    """The round core over 3 cells makes one Eq. 10 call for all cells,
    and each cell's outputs equal a one-cell call on that cell bitwise;
    the finalize core over the 3 cells equals three one-cell finalizes
    bitwise, an inactive cell keeping its params."""
    _, tm, train, test, parts = world
    tr = FederatedTrainer(tm, train, test, parts, port_cfg())
    prep = tr._prepare_round(0)
    params_c = {k: torch.stack([x, 1.01 * x, 0.99 * x])
                for k, x in tr.params.items()}
    batches_c = {k: torch.stack([x, x.flip(0), x])
                 for k, x in prep.batches.items()}
    sigma_calls = []

    def sigma_fn(p, images, labels):
        sigma_calls.append(labels.shape[0])
        return tr._sigma_all(p, images, labels)

    core = make_round_core(tm.loss_fn, sigma_fn, 0.1, 1)
    outs = core(params_c, batches_c, ())
    assert sigma_calls == [3]           # one Eq. 10 call for all cells

    def cell(tree, c):
        return {k: x[c:c + 1] for k, x in tree.items()}

    for c in range(3):
        one = core(cell(params_c, c), cell(batches_c, c), ())
        for a, b in zip(outs, one):
            for x, y in ((a[k], b[k]) for k in a) if isinstance(a, dict) \
                    else [(a, b)]:
                assert torch.equal(x[c], y[0])

    dev_params_c, _, _, deltas_c, _, _ = outs
    V = deltas_c["c1"].shape[1]
    w = torch.full((3, V), 1.0 / V)
    w[1] = 0.0
    w[1, 2] = 1.0                       # a single-upload cell
    active = [True, True, False]
    fin = make_finalize_core(1, 0.1)
    newp, norms = fin(params_c, dev_params_c, deltas_c, w, active)
    for c in range(3):
        p1, n1 = fin(cell(params_c, c), cell(dev_params_c, c),
                     cell(deltas_c, c), w[c:c + 1], active[c:c + 1])
        assert all(torch.equal(newp[k][c], p1[k][0]) for k in newp)
        assert torch.equal(norms[c], n1[0])
    assert torch.equal(newp["c1"][2], params_c["c1"][2])


def test_single_upload_norm_is_exactly_zero_across_cells():
    """The finalize core over several cells keeps the raw-delta centering
    order: one upload gives a norm of exactly 0 in every cell, and an
    inactive cell keeps its params."""
    core = make_finalize_core(tau=3, eta=0.07)
    rng = np.random.default_rng(0)
    deltas = {"w": torch.from_numpy(rng.normal(size=(2, 4, 5, 3))
                                    .astype(np.float32))}
    params = {"w": torch.from_numpy(rng.normal(size=(2, 5, 3))
                                    .astype(np.float32))}
    w = torch.tensor([[0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0]])
    newp, norms = core(params, deltas, deltas, w, [True, False])
    assert float(norms[0, 1]) == 0.0 and float(norms[1, 2]) == 0.0
    torch.testing.assert_close(newp["w"][0], deltas["w"][0, 1])
    assert torch.equal(newp["w"][1], params["w"][1])


# ---------------------------------------------------------------------------
# construction


def test_rejects_bad_configs(world, monkeypatch):
    _, tm, train, test, parts = world
    with pytest.raises(ValueError, match="batched scheduler"):
        port_engine(world, cells=2, scheduler="random")
    with pytest.raises(ValueError, match="num_cells"):
        port_engine(world, cells=0)
    with pytest.raises(ValueError, match="cell seeds"):
        MultiCellTrainer(tm, train, test, parts, port_cfg(cells=2),
                         cell_seeds=[0, 1, 2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_engine(world, cells=2, device=None)


def test_cell_params_from_jax_stacks_per_cell(world):
    jm, tm, *_ = world
    trees = [jm.init(jax.random.PRNGKey(c)) for c in range(2)]
    stacked = {k: np.stack([np.asarray(t[k]) for t in trees])
               for k in trees[0]}
    got = convert.cell_params_from_jax(stacked, tm.cfg, device="cpu")
    for c, t in enumerate(trees):
        one = convert.params_from_jax({k: np.asarray(v) for k, v in
                                       t.items()}, tm.cfg, device="cpu")
        for k in one:
            assert torch.equal(got[k][c], one[k])


def test_cli_runs_cells_on_cpu(capsys):
    from repro_torch.cli import main
    main(["--cells", "2", "--device", "cpu", "--backend", "torch",
          "--rounds", "2", "--devices", "8", "--classes", "3"])
    out = capsys.readouterr().out
    assert "multi-cell: 2 cells" in out
    assert "== fedcgd-fscd on cpu ==" in out
