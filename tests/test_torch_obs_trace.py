"""The port's spans on the profiler's clock (``repro_torch.obs``) and the
benchmark's readers of them (``portbench/layer_metrics``), on the CPU.

Spans carry Unix-epoch start and end times that agree with the
profiler's own ``obs:<name>`` ranges, a parent index and the round they
belong to; the FL trainers put evaluation under an ``eval`` span and
count its pulls apart from the round's; the LM train step traces its
trunk, head, backward and update only while live, and is bitwise the
same either way; off, nothing is traced at all.  The readers return
None where a run holds nothing to read and the right share on a
hand-made trace."""
import dataclasses
import math
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.obs as obs_pkg
from portbench import devtrace, harness
from repro_torch.configs import get_config
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.estimation import tree_leaves
from repro_torch.data import (sort_and_partition, synthetic_image_dataset,
                              train_test_split)
from repro_torch.fl import FederatedTrainer, FLConfig, MultiCellTrainer
from repro_torch.fl.distributed import make_train_step
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build_model
from repro_torch.obs import (DEFAULT, DEFAULT_RING, DISABLED, NULL_SPAN, Obs,
                             ObsConfig, SpanRecord, profile_rounds, tracing)

MICRO = dict(name="micro-cnn", kind="paper_cnn", num_classes=2,
             image_size=8, dropout=False, width=0.25)
PHASES = {"prep", "core", "schedule", "upload", "finalize"}
EVAL_BATCHES = 3            # 600 test images in batches of 256


@pytest.fixture(scope="module")
def micro_world():
    ds = synthetic_image_dataset(num_classes=2, num_per_class=40,
                                 image_size=8, seed=0)
    train, _ = train_test_split(ds, seed=0)
    test = synthetic_image_dataset(num_classes=2, num_per_class=300,
                                   image_size=8, seed=1)
    parts = sort_and_partition(train.labels, 8, 1,
                               np.random.default_rng(0))
    return build_model(CNNConfig(**MICRO)), train, test, parts


def make_trainer(world, enabled=True, cells=1, eval_every=1):
    cfg = FLConfig(num_devices=8, available_prob=0.7, batch_size=2, tau=1,
                   eval_every=eval_every, seed=0, scheduler_backend="torch",
                   device="cpu", num_cells=cells,
                   obs=ObsConfig(enabled=enabled, ring_size=8))
    cls = MultiCellTrainer if cells > 1 else FederatedTrainer
    return cls(*world, cfg)


@pytest.fixture
def clean_default():
    """The process-wide facade's ring emptied before and after."""
    DEFAULT.tracer.drain()
    yield DEFAULT
    DEFAULT.tracer.drain()


def _obs_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("obs:")]


# ---------------------------------------------------------------------------
# the tracer


def test_span_times_on_the_profilers_clock():
    """Each span's ends lie within 1 ms of the profiler's own range for
    it; the nested span's parent is its enclosing span's index."""
    obs = Obs(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]):    # the first range
        with record_function("warm-up"):                # sets up lazily
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            with obs.span("inner", k=1):
                time.sleep(0.003)
            time.sleep(0.003)
    spans = obs.tracer.drain()
    assert [(s.name, s.parent, s.depth) for s in spans] == [
        ("inner", 1, 1), ("outer", None, 0)]
    assert spans[0].tags == {"k": 1} and spans[1].tags is None
    events = {e.name()[4:]: e for e in _obs_events(prof)}
    assert set(events) == {"inner", "outer"}
    for s in spans:
        ev = events[s.name]
        assert abs(ev.start_ns() - s.t0_ns) < 1e6, s.name
        assert abs(ev.start_ns() + ev.duration_ns() - s.t1_ns) < 1e6, s.name
        assert s.t1_ns - s.t0_ns >= 3e6 and s.device_s is None
        assert abs((s.t1_ns - s.t0_ns) * 1e-9 - s.seconds) < 1e-3
    assert obs.tracer.spans() == []


def test_no_range_without_a_profiler():
    """A live span opens its ``obs:`` range only while a profiler
    records."""
    obs = Obs(enabled=True)
    calls = []
    real = tracing._record_function
    tracing._record_function = lambda name: calls.append(name) or real(name)
    try:
        with obs.span("a"):
            pass
        assert calls == []
        with profile(activities=[ProfilerActivity.CPU]):
            with obs.span("a"):
                pass
        assert calls == ["obs:a"]
    finally:
        tracing._record_function = real


def test_default_follows_the_profiler(clean_default):
    """``DEFAULT`` records spans while a profiler records and none
    otherwise, into a bounded ring; ``DISABLED`` stays inert."""
    assert not DEFAULT.enabled and DEFAULT.span("x") is NULL_SPAN
    with DEFAULT.span("x"):
        pass
    assert DEFAULT.tracer.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert DEFAULT.enabled and not DISABLED.enabled
        assert DISABLED.span("y") is NULL_SPAN
        with DEFAULT.span("x", n=2):
            pass
    assert not DEFAULT.enabled
    assert [(s.name, s.tags) for s in DEFAULT.tracer.spans()] == [
        ("x", {"n": 2})]
    assert DEFAULT.tracer.records.maxlen == DEFAULT_RING
    assert list(DISABLED.tracer.records) == []


def test_ring_keeps_parents_of_what_it_holds():
    """A bounded ring drops its oldest spans; ``parent`` indexes the list
    returned, and is None for a parent the ring no longer holds."""
    tr = tracing.Tracer(Obs(enabled=False).metrics, ring=3)
    with tr.span("r0"):
        with tr.span("c0"):
            pass
    with tr.span("r1"):
        with tr.span("c1"):
            pass
    spans = tr.spans()
    assert [(s.name, s.parent) for s in spans] == [
        ("r0", None), ("c1", 2), ("r1", None)]


def test_split_at_a_gradient_hook():
    """``split_hook`` splits the open span it names at the instant the
    gradient arrives, into two children that tile it."""
    obs = Obs(enabled=True)
    x = torch.ones(3, requires_grad=True)
    y = x * 2
    y.register_hook(obs.tracer.split_hook("bwd", "first", "second"))
    with obs.span("bwd"):
        y.sum().backward()
    spans = obs.tracer.drain()
    assert [(s.name, s.parent) for s in spans] == [
        ("first", 2), ("second", 2), ("bwd", None)]
    first, second, whole = spans
    assert first.t0_ns == whole.t0_ns and second.t1_ns == whole.t1_ns
    assert first.t1_ns == second.t0_ns
    assert first.seconds + second.seconds == pytest.approx(whole.seconds,
                                                           abs=1e-4)


# ---------------------------------------------------------------------------
# the FL trainers


def test_round_spans_parents_and_round(micro_world):
    """One round's record: ``round`` is the root, the five phases its
    children, ``eval`` a child of ``finalize``, the scheduler's span a
    child of ``schedule``; each child inside its parent in time, and the
    record's ``round`` the identifier the spans share."""
    tr = make_trainer(micro_world)
    tr.run(2)
    for j, rec in enumerate(tr.obs.records()):
        assert rec["round"] == j and set(rec["phases"]) == PHASES
        spans = rec["spans"]
        names = [s[0] for s in spans]
        root = names.index("round")
        assert spans[root][1] is None and names.count("round") == 1
        for name, parent, t0, t1, _ in spans:
            if name in PHASES:
                assert parent == root
            if parent is not None:
                assert spans[parent][2] <= t0 <= t1 <= spans[parent][3]
        assert spans[names.index("eval")][1] == names.index("finalize")
        assert spans[names.index("solve_many.torch")][1] == \
            names.index("schedule")
        assert rec["round_s"] == pytest.approx(
            1e-9 * (spans[root][3] - spans[root][2]), abs=1e-3)


@pytest.mark.parametrize("cells", [1, 2])
def test_eval_syncs_count_the_evaluation_batches(micro_world, cells):
    """With ``eval_every=1`` each round's record counts one pull a test
    batch of each cell in ``eval_syncs``, apart from ``host_syncs`` (the
    round's two); each cell's evaluation is an ``eval`` span of the
    engine's record, tagged with its cell; the phases are the five."""
    tr = make_trainer(micro_world, cells=cells)
    tr.run(2)
    recs = [r for r in tr.obs.records() if "phases" in r]
    assert len(recs) == 2
    for rec in recs:
        assert rec["eval_syncs"] == EVAL_BATCHES * cells
        assert rec["host_syncs"] == 2
        assert set(rec["phases"]) == PHASES
        evals = [s for s in rec["spans"] if s[0] == "eval"]
        assert len(evals) == cells
        if cells > 1:
            assert [s[4] for s in evals] == [{"cell": c}
                                             for c in range(cells)]
    assert tr.obs.metrics.histograms["span.eval"].count == 2 * cells
    assert EVAL_BATCHES == math.ceil(len(micro_world[2]) / 256)


def test_obs_off_trainer_is_untraced(micro_world, clean_default, tmp_path):
    """Observability off: the same params bit for bit as a traced
    trainer, no record, no span, no histogram; under ``profile_rounds``
    the shared no-op facade and ``DEFAULT`` record nothing and the trace
    holds no ``obs:`` range."""
    on, off = make_trainer(micro_world), make_trainer(micro_world, False)
    on.run(2)
    off.run(2)
    assert off.obs is DISABLED and off.obs.records() == []
    for k in on.params:
        assert torch.equal(on.params[k], off.params[k])
    assert [h["test_accuracy"] for h in on.history] == \
        [h["test_accuracy"] for h in off.history]
    out = profile_rounds(off, 1, tmp_path / "trace", warmup=0)
    assert out.phases == {}
    assert list(DISABLED.tracer.records) == []
    assert DEFAULT.tracer.spans() == []
    assert DISABLED.metrics.histograms == {}


def test_profile_rounds_busy_is_the_union():
    """``profile_rounds`` measures device time as the union of device
    intervals: ops that overlap count once."""
    from repro_torch.obs import profile as P
    assert P._union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25.0
    assert P._union_us([]) == 0.0


# ---------------------------------------------------------------------------
# the LM train step


def _lm_case():
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(),
                              dtype="float32", param_dtype="float32")
    params = TT.init(torch.Generator().manual_seed(5), cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 17)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "schedule_weights": torch.tensor([0.5, 0.5, 0.0, 0.0])}
    return cfg, params, batch


class _Counts:
    """Counts of hooks registered, CUDA events, clock reads and profiler
    ranges the tracer makes."""

    def __init__(self, monkeypatch):
        self.n = {"hook": 0, "event": 0, "clock": 0, "range": 0}
        hook = torch.Tensor.register_hook
        monkeypatch.setattr(torch.Tensor, "register_hook",
                            lambda t, fn: self._bump("hook", hook, t, fn))
        for name, key in (("_cuda_event", "event"), ("perf_counter", "clock"),
                          ("time_ns", "clock"),
                          ("_record_function", "range")):
            real = getattr(tracing, name)
            monkeypatch.setattr(tracing, name, lambda *a, real=real, key=key:
                                self._bump(key, real, *a))

    def _bump(self, key, fn, *a):
        self.n[key] += 1
        return fn(*a)


def test_lm_step_traced_and_untraced_alike(monkeypatch, clean_default):
    """The tiny f32 step returns the same params and metrics bit for bit
    with tracing on and off.  Off (``DEFAULT`` not live), it registers no
    hook, records no event, reads no clock and opens no range; on, its
    spans form one ``lm.step`` tree per call, ``lm.backward`` split at
    the trunk's gradient hook, with no device time on the CPU."""
    cfg, params, batch = _lm_case()
    counts = _Counts(monkeypatch)
    new_off, met_off = make_train_step(cfg, eta=0.1, federated=True)(
        params, batch)
    assert counts.n == {"hook": 0, "event": 0, "clock": 0, "range": 0}
    assert DEFAULT.tracer.spans() == []
    obs = Obs(enabled=True)
    step = make_train_step(cfg, eta=0.1, federated=True, obs=obs)
    for _ in range(2):
        new_on, met_on = step(params, batch)
    assert counts.n["hook"] == 2 and counts.n["event"] == 0
    assert counts.n["clock"] > 0 and counts.n["range"] == 0
    for a, b in zip(tree_leaves(new_on), tree_leaves(new_off)):
        assert torch.equal(a, b)
    assert met_on.keys() == met_off.keys()
    assert all(torch.equal(met_on[k], met_off[k]) for k in met_on)

    spans = obs.tracer.drain()
    tree = [(s.name, None if s.parent is None else spans[s.parent].name)
            for s in spans]
    one = [("lm.trunk", "lm.step"), ("lm.head", "lm.step"),
           ("lm.head_bwd", "lm.backward"), ("lm.trunk_bwd", "lm.backward"),
           ("lm.backward", "lm.step"), ("lm.update", "lm.step"),
           ("lm.step", None)]
    assert tree == one + one
    assert all(s.device_s is None for s in spans)
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns


def test_lm_step_follows_the_profiler(clean_default):
    """The step's default facade is ``DEFAULT``: under a profiler its
    spans land in the ring, each with its ``obs:`` range."""
    cfg, params, batch = _lm_case()
    step = make_train_step(cfg, eta=0.1, federated=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, batch)
    names = [s.name for s in DEFAULT.tracer.spans()]
    assert names[-1] == "lm.step" and len(names) == 7
    # the backward's two halves are cut from its span, with no range
    assert sorted(e.name()[4:] for e in _obs_events(prof)) == sorted(
        set(names) - {"lm.head_bwd", "lm.trunk_bwd"})


# ---------------------------------------------------------------------------
# the benchmark's readers


def _reader(name):
    return harness.load_module(harness.BENCH / "layer_metrics"
                               / f"{name}.py").read


NEW_READERS = ["fl.eval_ms", "fl.eval_syncs", "fl.idle_prep_pct",
               "fl.idle_eval_pct", "fl.idle_unspanned_pct", "lm.head_ms",
               "lm.update_ms"]
T0 = 1_700_000_000_000_000_000          # ns, a Unix-epoch instant


class _Ev:
    """A kineto event of the shape ``devtrace.DeviceRecord`` reads."""

    def __init__(self, name, start_ms, end_ms, cuda):
        self._name, self._cuda = name, cuda
        self._s, self._d = T0 + int(start_ms * 1e6), int((end_ms - start_ms)
                                                         * 1e6)

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return False


def _span(name, parent, t0_ms, t1_ms, tags=None):
    return [name, parent, T0 + int(t0_ms * 1e6), T0 + int(t1_ms * 1e6), tags]


def _fl_run(trace=True):
    """A 100 ms traced window over one round (5-95 ms: prep 5-20, core
    20-60, finalize 60-95 holding eval 70-90) and a round that began
    before the window; the device idles 3-5 (no round), 10-20 (prep),
    75-80 (eval) and 96-98 (no round)."""
    busy = [(0, 3), (5, 10), (20, 75), (80, 96), (98, 100)]
    events = [_Ev(devtrace.WINDOW, 0, 100, False)] + [
        _Ev("kernel", s, e, True) for s, e in busy]
    traced = {"round": 7, "eval_syncs": 20, "spans": [
        _span("prep", 4, 5, 20), _span("core", 4, 20, 60),
        _span("eval", 3, 70, 90, {"cell": 0}), _span("finalize", 4, 60, 95),
        _span("round", None, 5, 95)]}
    before = {"round": 6, "eval_syncs": 0, "spans": [
        _span("prep", 1, -10, 4.5), _span("round", None, -10, 4.5)]}
    rec = devtrace.DeviceRecord(events, {}) if trace else None
    engine = types.SimpleNamespace(obs=types.SimpleNamespace(
        records=lambda: [before, traced]))
    return harness.Run(1.0, [], 1.0, types.SimpleNamespace(engine=engine),
                       {"records": [before, traced], "trace": rec})


def test_readers_none_without_anything_to_read():
    """No trace, no records, no spans: every new reader returns None."""
    empty = harness.Run(1.0, [], 1.0, types.SimpleNamespace(trace_steps=2),
                        {})
    for name in NEW_READERS:
        assert _reader(name)(empty) is None, name
    plain = _fl_run()
    for r in plain.layer["records"]:
        del r["spans"]                  # a program without spans
    for name in NEW_READERS:
        assert _reader(name)(plain) is None, name
    notrace = _fl_run(trace=False)
    for name in ("fl.idle_prep_pct", "fl.idle_eval_pct",
                 "fl.idle_unspanned_pct", "lm.head_ms", "lm.update_ms"):
        assert _reader(name)(notrace) is None, name


def test_fl_readers_on_a_hand_made_trace():
    """The 10 ms prep gap reads 10 % of the 100 ms window, the eval gap
    5 %, the gaps outside any round 4 %: with no idle under the other
    phases they add up to the device's idle share, 19 %."""
    run = _fl_run()
    rec = run.layer["trace"]
    # the trace's times are float seconds since the epoch: 0.24 us apart
    pct = dict(abs=1e-3)
    assert rec.window_s == pytest.approx(0.1, rel=1e-5)
    assert _reader("fl.idle_prep_pct")(run) == pytest.approx(10.0, **pct)
    assert _reader("fl.idle_eval_pct")(run) == pytest.approx(5.0, **pct)
    assert _reader("fl.idle_unspanned_pct")(run) == pytest.approx(4.0, **pct)
    assert _reader("device_idle_pct.fl")(run) == pytest.approx(19.0, **pct)
    assert _reader("fl.eval_ms")(run) == pytest.approx(20.0)
    assert _reader("fl.eval_syncs")(run) == 20.0
    # an eight-cell round sums its cells' evaluations
    run.layer["records"][1]["spans"].insert(
        0, _span("eval", 4, 62, 69, {"cell": 1}))
    assert _reader("fl.eval_ms")(run) == pytest.approx(27.0)
    # a traced window with no evaluation in it: no idle under eval
    run.layer["records"][1]["spans"] = [
        s for s in run.layer["records"][1]["spans"] if s[0] != "eval"]
    assert _reader("fl.idle_eval_pct")(run) == 0.0


class _CudaEv:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_lm_readers_on_hand_made_steps(monkeypatch):
    """Three steps in the ring, the last two traced: ``lm.head_ms`` is the
    mean of lm.head + lm.head_bwd device ms over those two, and
    ``lm.update_ms`` of lm.update."""
    spans = []

    def add(name, parent, start, end):
        spans.append(SpanRecord(name, 0, 0.0, None, 0, 0, parent,
                                (_CudaEv(start), _CudaEv(end))))
        return len(spans) - 1

    for k, (head, bwd, upd) in enumerate([(100, 100, 100), (300, 50, 20),
                                          (500, 70, 40)]):
        base = len(spans)
        # children first, the parent's index filled in below
        add("lm.trunk", base + 6, 0, 1000)
        add("lm.head", base + 6, 0, head)
        add("lm.head_bwd", base + 5, 0, bwd)
        add("lm.trunk_bwd", base + 5, 0, 900)
        add("lm.update", base + 6, 0, upd)
        add("lm.backward", base + 6, 0, 1000)
        add("lm.step", None, 0, 3000)
        assert len(spans) == base + 7 and k < 3
    fake = types.SimpleNamespace(tracer=types.SimpleNamespace(
        spans=lambda: list(spans)))
    monkeypatch.setattr(obs_pkg, "DEFAULT", fake)
    run = harness.Run(1.0, [], 1.0, types.SimpleNamespace(trace_steps=2),
                      {"trace": object()})
    assert _reader("lm.head_ms")(run) == pytest.approx((350 + 570) / 2)
    assert _reader("lm.update_ms")(run) == pytest.approx(30.0)
    # on the CPU the spans have no device events
    for s in spans:
        s.events = None
    assert _reader("lm.head_ms")(run) is None
