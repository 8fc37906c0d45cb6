"""``correct`` comes out false where it must, at a size a test run can
hold (``--device cpu --tiny``, the cells' own limits):

* the control, the reference one precision below the configuration's
  (TF32 operands for the f32 ResNet cells, fp8 for the bf16 LM) in the
  program's place;
* a whole run with the timed path broken underneath, once for each
  fault the cells can have: a step that returns its state unchanged,
  half of each batch left out (the mean over the rest), and the
  schedule, the answer FedCGD produces, altered where it is made.  (The
  cells run on one chip: there is no exchange between chips to leave
  out.)
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import harness, run  # noqa: E402

torch.set_num_threads(2)     # in-process runs beside the other workers

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
FL_CELLS = [c for c in CELLS if c.startswith("resnet18gn")]
LM_CELLS = [c for c in CELLS if c.startswith("rwkv6")]
SEED = 2 ** 31 + 777


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_planted_faults_are_caught(cell):
    c = harness.Cell(cell)
    d = c.driver(seed=SEED, device=torch.device("cpu"), tiny=True)
    d.setup()
    d.release()
    limits = c.workload["limits"]
    assert not _fails(d.numbers(), limits)
    assert _fails(d.numbers(d.CONTROL), limits)
    for side in d.FAULTS.values():
        assert _fails(d.numbers(side), limits), side


def _flip_first(mask):
    mask = mask.copy()
    mask[0] = not mask[0]
    return mask


def _fl_unchanged(mp):
    from repro_torch.fl import rounds
    make = rounds.make_finalize_core

    def patched(tau, eta):
        core = make(tau, eta)

        def broken(params_c, *a):
            return params_c, core(params_c, *a)[1]
        return broken
    mp.setattr(rounds, "make_finalize_core", patched)


def _fl_half(mp):
    from repro_torch.fl import rounds
    make = rounds.make_round_core

    def patched(*a):
        core = make(*a)

        def broken(params_c, batches_c, dropout_c=()):
            b = batches_c["labels"].shape[3]
            return core(params_c, {k: x[:, :, :, :b // 2]
                                   for k, x in batches_c.items()},
                        dropout_c)
        return broken
    mp.setattr(rounds, "make_round_core", patched)


def _fl_answer(mp):
    import dataclasses

    from repro_torch.core import scheduling as S
    solve = S.solve_many

    def broken(*a, **kw):
        return [dataclasses.replace(s, mask=_flip_first(s.mask))
                for s in solve(*a, **kw)]
    mp.setattr(S, "solve_many", broken)


def _lm_unchanged(mp):
    from repro_torch.fl import distributed
    make = distributed.make_train_step

    def patched(*a, **kw):
        step = make(*a, **kw)

        def broken(params, batch):
            return params, step(params, batch)[1]
        return broken
    mp.setattr(distributed, "make_train_step", patched)


def _lm_half(mp):
    from repro_torch.fl import distributed
    make = distributed.make_train_step

    def patched(*a, **kw):
        step = make(*a, **kw)

        def broken(params, batch):
            w = batch["schedule_weights"].clone()
            w[len(w) // 2:] = 0
            return step(params, dict(batch, schedule_weights=w))
        return broken
    mp.setattr(distributed, "make_train_step", patched)


def _lm_answer(mp):
    import dataclasses

    import repro_torch.core as core
    fscd = core.fscd

    def broken(prob, *a, **kw):
        s = fscd(prob, *a, **kw)
        return dataclasses.replace(s, mask=_flip_first(s.mask))
    mp.setattr(core, "fscd", broken)


FAULTS = ([(c, f) for c in FL_CELLS
           for f in (_fl_unchanged, _fl_half, _fl_answer)]
          + [(c, f) for c in LM_CELLS
             for f in (_lm_unchanged, _lm_half, _lm_answer)])


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_run_with_a_broken_program_is_not_correct(cell, fault, monkeypatch,
                                                  capsys):
    fault(monkeypatch)
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "0.5", "--device", "cpu", "--tiny"], t0=0.0)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
