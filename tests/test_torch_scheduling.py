"""The torch scheduler engine (CPU, plain scans) against the numpy
solvers: masks and iteration counts bitwise equal.

On ``tests/test_solve_many.py``'s random problems no two candidates tie,
and the engine equals the reference solvers ``repro.core.scheduling``.
The trainer's problems are full of exact ties (devices with equal label
histograms under equal class weights); there the reference breaks ties
by BLAS rounding noise, and the engine is held against the port's own
numpy solvers, whose candidate sums run in a fixed class order."""
import numpy as np
import pytest

from repro.core import scheduling as RS
from repro_torch.core import scheduling as S

RNG_PROBLEMS = 24


def random_problem(rng, V, C=8, infeasible_frac=0.0, cls=S.Problem):
    p_dev = rng.dirichlet(np.full(C, 0.4), size=V)
    min_bw = rng.uniform(0.4, 1.6, V)
    if infeasible_frac:
        bad = rng.random(V) < infeasible_frac
        min_bw[bad] = -1.0
    return cls(
        p_dev=p_dev, global_dist=rng.dirichlet(np.full(C, 3.0)),
        class_weights=rng.uniform(0.5, 1.5, C),
        sigma=float(rng.uniform(2.0, 6.0)), batch_size=32,
        min_bw=min_bw, total_bw=V * 0.5)


def tied_problem(rng, V, C=10):
    """A trainer-like P1 instance: single-class sampled histograms (many
    exactly equal rows), equal class weights, Eq. 9-scale bandwidths."""
    labels = rng.integers(0, C, V)
    p_dev = np.eye(C)[labels]
    mixed = rng.random(V) < 0.2
    p_dev[mixed] = rng.dirichlet(np.full(C, 0.3), size=int(mixed.sum()))
    min_bw = rng.lognormal(13.8, 0.8, V)
    min_bw[rng.random(V) < 0.1] = -1.0
    return S.Problem(p_dev=p_dev, global_dist=np.full(C, 1.0 / C),
                     class_weights=np.full(C, rng.uniform(50, 200)),
                     sigma=float(rng.uniform(2.0, 6.0)), batch_size=32,
                     min_bw=min_bw, total_bw=20e6)


def assert_same(expect, got, tag):
    assert len(expect) == len(got)
    for t, (e, g) in enumerate(zip(expect, got)):
        assert np.array_equal(e.mask, g.mask), (tag, t)
        assert e.iterations == g.iterations, (tag, t)
        assert np.isclose(e.objective, g.objective, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("algorithm", ["gs", "fscd"])
@pytest.mark.parametrize("V", [8, 16, 64])
def test_engine_matches_reference_numpy(algorithm, V, seed):
    rng = np.random.default_rng([1000 + V, seed])
    probs = [random_problem(rng, V,
                            infeasible_frac=0.2 if t % 3 == 0 else 0.0,
                            cls=RS.Problem)
             for t in range(RNG_PROBLEMS)]
    ref_fn = {"gs": RS.greedy_scheduling, "fscd": RS.fscd}[algorithm]
    expect = [ref_fn(p) for p in probs]
    port_probs = [S.Problem(**vars(p)) for p in probs]
    got = S.solve_many(port_probs, algorithm, backend="torch", device="cpu")
    assert_same(expect, got, (algorithm, V, seed))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("algorithm", ["gs", "fscd"])
def test_engine_matches_port_numpy_on_tied_problems(algorithm, seed):
    rng = np.random.default_rng([77, seed])
    probs = [tied_problem(rng, V) for V in (19, 19, 23, 64) for _ in range(3)]
    fn = {"gs": S.greedy_scheduling, "fscd": S.fscd}[algorithm]
    expect = [fn(p) for p in probs]
    by_shape = {}
    for i, p in enumerate(probs):
        by_shape.setdefault(p.num_devices, []).append(i)
    for idx in by_shape.values():
        got = S.solve_many([probs[i] for i in idx], algorithm,
                           backend="torch", device="cpu")
        assert_same([expect[i] for i in idx], got, (algorithm, seed))


def test_mixed_feasibility_and_edge_cases():
    rng = np.random.default_rng(9)
    probs = [random_problem(rng, 10) for _ in range(3)]
    dead = random_problem(rng, 10)
    dead.min_bw[:] = -1.0
    probs.append(dead)
    ref_probs = [RS.Problem(**vars(p)) for p in probs]
    for alg, fn in (("gs", RS.greedy_scheduling), ("fscd", RS.fscd)):
        got = S.solve_many(probs, alg, backend="torch", device="cpu")
        assert_same([fn(p) for p in ref_probs], got, alg)
        assert not got[-1].mask.any()


def test_solve_many_validates_inputs():
    rng = np.random.default_rng(2)
    assert S.solve_many([], "gs", device="cpu") == []
    with pytest.raises(ValueError):
        S.solve_many([random_problem(rng, 8)], "not-an-algorithm",
                     device="cpu")
    with pytest.raises(ValueError):
        S.solve_many([random_problem(rng, 8)], "gs", backend="jax",
                     device="cpu")
    with pytest.raises(ValueError):
        S.solve_many([random_problem(rng, 8), random_problem(rng, 12)],
                     "gs", device="cpu")


def test_solve_many_obs_counts_host_syncs():
    from repro_torch.obs import Obs
    rng = np.random.default_rng(4)
    probs = [random_problem(rng, 16) for _ in range(4)]
    obs = Obs(enabled=True)
    got = S.solve_many(probs, "fscd", backend="torch", obs=obs,
                       device="cpu")
    c = obs.metrics.counters
    assert c["sched.solve_many_calls.torch"].value == 1
    assert c["sched.problems_total"].value == 4
    assert c["sched.iterations_total"].value == sum(g.iterations
                                                    for g in got)
    assert c["sched.host_syncs.torch"].value > 0
    assert obs.metrics.histograms["span.solve_many.torch"].count == 1
