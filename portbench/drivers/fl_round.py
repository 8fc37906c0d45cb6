"""Driver ``fl_round``: the paper's experiment, one
``FederatedTrainer.run_round`` after another on the configuration's
world (lossless channel, the torch scheduler: K1/K2 through
``solve_many``, K3 for the Eq. 10 sigmas, the fused round core and
finalize).

Set-up makes the world and the weights from the seed, builds the
trainer, hands it the weights and runs its first ``check_rounds``
rounds with their schedule, sigmas, local losses and models recorded
(they also warm every path the window takes: the round core, the
scheduler's kernels and, in round 0, the evaluation).  The window then
continues the same trainer.  The check replays the recorded rounds with
the reference (``reference/fedcgd.py``) from the same world and weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness import subseed
from portbench.reference import compare, fedcgd
from portbench.traffic import fl_world, weights

# the launch counters of the FL kernels and the device kernels each runs
FL_KERNELS = {"persample_gradnorm": ["psg_kernel"],
              "wemd_add": ["wemd_add_kernel"],
              "wemd_swap": ["wemd_swap_kernel"]}
EVAL_IMAGES = 20 * 256           # FederatedTrainer.evaluate's default


class Driver:
    cells = 1

    def __init__(self, cell, seed, device, tiny=False, traced=False):
        self.cell, self.seed, self.device = cell, seed, device
        self.traced = traced
        w = cell.workload
        tiny_w = w.get("tiny", {}) if tiny else {}
        self.fl = {**w["fl"], **tiny_w.get("fl", {})}
        self.world_p = {**w["world"], **tiny_w.get("world", {})}
        self.model_p = {**cell.config["model"], **tiny_w.get("model", {})}
        self.check_rounds = w["check_rounds"]
        self.trace_rounds = w["trace_rounds"]
        self.limits = w["limits"]
        self.round_flops = []
        self._ref = {}

    # ------------------------------------------------------------------
    def _flconfig(self, seed):
        from repro_torch.fl.rounds import FLConfig
        from repro_torch.obs import ObsConfig
        fl = self.fl
        return FLConfig(
            num_devices=fl["num_devices"],
            available_prob=fl["available_prob"],
            batch_size=fl["batch_size"], tau=fl["tau"], eta=fl["eta"],
            deadline_s=fl["deadline_s"], scheduler=fl["scheduler"],
            scheduler_backend=fl["scheduler_backend"],
            device=str(self.device),
            payload_bits_override=float(fl["payload_bits"]), seed=seed,
            sigma_init=fl["sigma_init"], g_init=fl["g_init"],
            eval_every=fl["eval_every"], num_cells=self.cells,
            obs=ObsConfig(enabled=self.traced, ring_size=1 << 16))

    def _model(self):
        from repro_torch.configs.paper_cnn import RESNET18_GN_CIFAR100
        from repro_torch.models.registry import build_model
        m = self.model_p
        return build_model(dataclasses.replace(
            RESNET18_GN_CIFAR100, num_classes=m["num_classes"],
            image_size=m["image_size"], channels=m["channels"],
            gn_groups=m["gn_groups"]))

    def trainer_seed(self, c=0):
        return subseed(self.seed, "trainer") + c

    def build(self, model, world):
        from repro_torch.fl.rounds import FederatedTrainer
        self.engine = FederatedTrainer(model, _dataset(world, "train"),
                                       _dataset(world, "test"), world.parts,
                                       self._flconfig(self.trainer_seed()))
        self.trainers = [self.engine]

    def install(self, params):
        self.engine.params = {k: v.clone() for k, v in params[0].items()}

    def _hook_schedule(self, recs):
        """Record each trainer's first schedule of a round."""
        t = self.engine
        orig = t._schedule

        def schedule(prob, *a):
            s = orig(prob, *a)
            recs[0].setdefault("mask", s.mask.copy())
            return s
        t._schedule = schedule
        return [(t, "_schedule")]

    # ------------------------------------------------------------------
    def setup(self):
        m = self.model_p
        self.world = fl_world.make(self.world_p, self.seed, self.device)
        self.params0 = []
        for c in range(self.cells):
            gen = torch.Generator(device=self.device).manual_seed(
                subseed(self.seed, f"weights{c}"))
            self.params0.append(weights.resnet18gn(
                gen, m["num_classes"], m["channels"], self.device))
        self.model = self._model()
        self.build(self.model, self.world)
        self.install(self.params0)
        self.prog = self._record(self.check_rounds)
        self.next_round = self.check_rounds

    def _record(self, n):
        """Run ``n`` rounds, recording each trainer's availability, local
        losses, sigmas, schedule and model (the hooks go afterwards)."""
        out = [[] for _ in self.trainers]
        recs = [{} for _ in self.trainers]
        hooks = self._hook_schedule(recs)
        for t, rec in zip(self.trainers, recs):
            orig = t._post_core

            def post(prep, losses, sigma, rec=rec, orig=orig):
                rec.update(avail=prep.avail_idx.copy(),
                           losses=np.array(losses), sigma=np.array(sigma))
                return orig(prep, losses, sigma)
            t._post_core = post
            hooks.append((t, "_post_core"))
        try:
            for j in range(n):
                for rec in recs:
                    rec.clear()
                self.engine.run_round(j)
                self._sync()
                for c, (t, rec) in enumerate(zip(self.trainers, recs)):
                    out[c].append(dict(rec, params={
                        k: v.detach().clone() for k, v in t.params.items()}))
        finally:
            for obj, name in hooks:
                delattr(obj, name)
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------------
    def step(self):
        j = self.next_round
        self.engine.run_round(j)
        self._sync()
        self.next_round += 1
        self.round_flops.append(self._flops_of_round())
        return 1

    def _flops_of_round(self):
        """Model FLOPs of the last round: 3 forwards of each local-update
        sample of an available device (padding rows not counted) and 1 of
        each evaluated image."""
        from portbench.counts import resnet18gn as RC
        fwd = RC.forward_flops(self.model_p)
        fl = self.fl
        flops = 0.0
        for t in self.trainers:
            rec = t.history[-1]
            flops += 3 * fwd * rec["num_available"] * fl["tau"] * \
                fl["batch_size"]
            if "test_accuracy" in rec:
                flops += fwd * min(len(t.test), EVAL_IMAGES)
        return flops

    def layer_data(self, steps):
        from portbench import devtrace
        recs = [r for r in self.engine.obs.records()
                if r.get("kind") in ("round", "multicell_round")
                and "phases" in r][-len(steps):]
        out = {"records": recs, "flops": list(self.round_flops),
               "trace": None}
        if self.device.type == "cuda":
            out["trace"] = devtrace.capture(self.step, self.trace_rounds,
                                            FL_KERNELS)
        return out

    # ------------------------------------------------------------------
    def fl_dict(self, c=0):
        return dict(self.fl, seed=self.trainer_seed(c))

    def reference(self, c, **kw):
        """The reference's record of cell c (the plain one kept)."""
        if kw:
            return fedcgd.replay(self.world, self.fl_dict(c),
                                 self.params0[c], self.check_rounds,
                                 self.device, **kw)
        if c not in self._ref:
            self._ref[c] = self.reference(c, rnd=None)
        return self._ref[c]

    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("engine", "trainers", "model"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def numbers(self, side=None):
        """The compared numbers, worst over the cells: the program's
        record against the reference's, or with ``side`` (a dict of
        ``replay`` options) the reference so changed in the program's
        place."""
        worst = {}
        for c in range(self.cells):
            ref = self.reference(c)
            prog = self.prog[c] if side is None else self.reference(c, **side)
            nums = compare.fl_numbers(prog, ref, self.params0[c])
            self.worst = nums.pop("worst")
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def check(self):
        self.release()
        nums = self.numbers()
        return [(k, nums[k], float(self.limits[k])) for k in self.limits]

    CONTROL = {"rnd": fedcgd.tf32}
    FAULTS = {"half": {"fault": "half"}, "answer": {"fault": "answer"}}


def _dataset(world, part):
    from repro_torch.data.datasets import ArrayDataset
    return ArrayDataset(getattr(world, f"{part}_x"),
                        getattr(world, f"{part}_y"), world.classes)
