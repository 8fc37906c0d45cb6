"""``repro_torch.obs.profile_rounds`` on the CPU (the counterpart of
``tests/test_obs.py::test_profile_rounds_smoke``): the reference's
signature and round semantics, the trace directory it returns and the
numbers it carries, the phase split from the ``obs`` spans, and no
extra host pull or lasting change to the trainer.  On the card
``chip_smoke.py`` reads its device numbers."""
import os

import numpy as np
import pytest

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.data import (sort_and_partition, synthetic_image_dataset,
                              train_test_split)
from repro_torch.fl import FederatedTrainer, FLConfig, MultiCellTrainer
from repro_torch.models.registry import build_model
from repro_torch.obs import DISABLED, ObsConfig, Profile, profile_rounds

MICRO = dict(name="micro-cnn", kind="paper_cnn", num_classes=2,
             image_size=8, dropout=False, width=0.25)
PHASES = {"prep", "core", "schedule", "upload", "finalize"}


@pytest.fixture(scope="module")
def micro_world():
    ds = synthetic_image_dataset(num_classes=2, num_per_class=40,
                                 image_size=8, seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 8, 1,
                               np.random.default_rng(0))
    return build_model(CNNConfig(**MICRO)), train, test, parts


def make_trainer(world, enabled=True, cells=1):
    cfg = FLConfig(num_devices=8, available_prob=0.7, batch_size=2, tau=1,
                   eval_every=0, seed=0, scheduler_backend="torch",
                   device="cpu", num_cells=cells,
                   obs=ObsConfig(enabled=enabled, ring_size=8))
    cls = MultiCellTrainer if cells > 1 else FederatedTrainer
    return cls(*world, cfg)


def test_profile_rounds_smoke(micro_world, tmp_path):
    tr = make_trainer(micro_world)
    out = profile_rounds(tr, 1, tmp_path / "trace", warmup=1)
    assert len(tr.history) == 2     # warmup + traced round both ran
    assert isinstance(out, (str, Profile)) and os.path.isdir(out)
    assert os.path.getsize(os.path.join(out, "trace.json")) > 0
    with pytest.raises(ValueError):
        profile_rounds(tr, 0, tmp_path / "t2")
    assert len(tr.history) == 2


def test_profile_rounds_continues_from_history(micro_world, tmp_path):
    """Rounds continue from ``len(history)``; a profiled round makes the
    round's 2 host pulls, like the others."""
    tr = make_trainer(micro_world)
    tr.run(2)
    out = profile_rounds(tr, 2, tmp_path / "t", warmup=0)
    assert [h["round"] for h in tr.history] == [0, 1, 2, 3]
    assert tr.last_round_host_syncs == 2
    assert out.wall_ms > 0
    # a CPU trainer: no device was traced
    assert out.device_ms is None and out.busy_share is None
    assert out.device_ops is None


def test_profile_rounds_splits_by_phase(micro_world, tmp_path):
    """With observability on, every phase span is a range of the trace,
    split as the rounds' records split them (nested spans fold into their
    phase); the facade is left as it was, and the records keep their
    phases."""
    tr = make_trainer(micro_world)
    out = profile_rounds(tr, 2, tmp_path / "t", warmup=1)
    assert set(out.phases) == PHASES        # solve_many.torch is schedule's
    assert "span" not in vars(tr.obs)
    for ph in out.phases.values():
        assert ph["wall_ms"] >= 0 and ph["device_ms"] is None
    assert sum(ph["wall_ms"] for ph in out.phases.values()) <= out.wall_ms
    recs = tr.obs.records()
    assert len(recs) == 3 and all(set(r["phases"]) == PHASES for r in recs)


def test_profile_rounds_with_obs_disabled(micro_world, tmp_path):
    """Observability off: no phase split, the shared no-op facade
    untouched, 2 host pulls a round."""
    tr = make_trainer(micro_world, enabled=False)
    assert tr.obs is DISABLED
    out = profile_rounds(tr, 1, tmp_path / "t", warmup=1)
    assert out.phases == {} and "span" not in vars(DISABLED)
    assert tr.last_round_host_syncs == 2


def test_profile_rounds_multicell(micro_world, tmp_path):
    mc = make_trainer(micro_world, cells=2)
    out = profile_rounds(mc, 1, tmp_path / "t", warmup=1)
    assert len(mc.history) == 2 and os.path.isdir(out)
    assert set(out.phases) == PHASES
