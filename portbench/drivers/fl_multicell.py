"""Driver ``fl_multicell``: ``MultiCellTrainer.run_round`` over
``num_cells`` independent cells (one round core over the stacked cells,
one batched ``solve_many``, one finalize), the world otherwise as
``fl_round``'s.  Each cell gets its own weights from the seed and is
held to the reference on its own; the compared numbers are the worst
cell's."""
from __future__ import annotations

import torch

from portbench.harness import BENCH, load_module

_fl = load_module(BENCH / "drivers" / "fl_round.py")


class Driver(_fl.Driver):

    def __init__(self, cell, *a, **kw):
        super().__init__(cell, *a, **kw)
        self.cells = int(self.fl["num_cells"])

    def build(self, model, world):
        from repro_torch.fl.multicell import MultiCellTrainer
        self.engine = MultiCellTrainer(
            model, _fl._dataset(world, "train"), _fl._dataset(world, "test"),
            world.parts, self._flconfig(self.trainer_seed()))
        self.trainers = list(self.engine.cells)

    def install(self, params):
        mc = self.engine
        mc._params_c = {k: torch.stack([p[k] for p in params])
                        for k in params[0]}
        for c, t in enumerate(self.trainers):
            t.params = {k: x[c] for k, x in mc._params_c.items()}

    def _hook_schedule(self, recs):
        mc = self.engine
        orig = mc._solve_batch

        def solve(probs):
            scheds = orig(probs)
            for rec, s in zip(recs, scheds):
                rec.setdefault("mask", s.mask[:len(rec["avail"])].copy())
            return scheds
        mc._solve_batch = solve
        return [(mc, "_solve_batch")]
