"""Driver ``lm_silos``: FedCGD over LM silos, as the port's
``launch/federated_lm_silos.run`` trains: each round the program's
``core.fscd`` picks the silo group over the silos' token histograms, then
one schedule-weighted step of ``make_train_step(cfg, eta,
federated=True)`` (Eq. 2 as per-row loss weights) trains on every
silo's rows.

Set-up draws the weights from the seed on the device, builds the step
and runs the first ``check_steps`` rounds with their schedules, losses,
grad norms and the model's change leaf by leaf recorded (the first round
also builds and warms every kernel).  The window continues the same
params.  The check frees the program's state, draws the same weights
again and replays the recorded rounds with the reference
(``reference/rwkv6.py``).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from portbench.harness import subseed
from portbench.reference import compare, fedcgd
from portbench.reference import rwkv6 as ref
from portbench.traffic import weights
from portbench.traffic.lm_silos import SiloWorld

# a leaf's state holds its step where it misses the step by at most 1 %
HELD = 0.01
LM_KERNELS = {"wkv": ["wkv_chunked"],
              "wkv_bwd": ["wkv_bwd_chunked", "wkv_bwd_du"]}


def leaves(tree):
    """{name: tensor} with each stacked layer leaf split by layer."""
    out = {}
    for name, x in ref._flat(tree):
        if name.startswith("blocks."):
            for i in range(x.shape[0]):
                out[f"{name}.{i}"] = x[i]
        else:
            out[name] = x
    return out


def held_share(new, old, grads, eta):
    """{leaf: ||(new - old) + eta g|| / ||eta g||}: how far the state
    after a step misses the step itself (0 where it holds the update
    whole; near 1 where rounding to the leaf's dtype swallows it)."""
    ln, lo, lg = leaves(new), leaves(old), leaves(grads)
    out = {}
    for k in ln:
        step = eta * lg[k]
        out[k] = float(torch.linalg.vector_norm(
            ln[k].float() - lo[k].float() + step)) / max(
            float(torch.linalg.vector_norm(step)), 1e-30)
    return out


def change_norms(a, b):
    """{leaf: ||a - b||} in f32 sums (each stacked leaf one layer at a
    time)."""
    la, lb = leaves(a), leaves(b)
    return {k: float(torch.linalg.vector_norm(
        la[k].float() - lb[k].float())) for k in la}


class Driver:
    def __init__(self, cell, seed, device, tiny=False, traced=False):
        self.cell, self.seed, self.device = cell, seed, device
        self.traced = traced
        w = cell.workload
        t = w.get("tiny", {}) if tiny else {}
        self.model_p = {**cell.config["model"], **t.get("model", {})}
        self.traffic = {**w["silos"], **t.get("silos", {})}
        self.eta = w["eta"]
        self.check_steps = w["check_steps"]
        self.trace_steps = w["trace_steps"]
        self.limits = w["limits"]
        self.sched_s = []
        self.tokens = []

    def _cfg(self):
        from repro_torch.configs import get_config
        m = self.model_p
        fields = {f.name for f in dataclasses.fields(get_config(m["arch"]))}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in m.items() if k in fields}
        return dataclasses.replace(get_config(m["arch"]), **kw)

    def _weights(self):
        gen = torch.Generator(device=self.device).manual_seed(
            subseed(self.seed, "weights"))
        return weights.rwkv6(gen, self.cfg, self.device)

    def setup(self):
        from repro_torch.fl.distributed import make_train_step
        self.cfg = self._cfg()
        self.world = SiloWorld(self.cfg.vocab_size, self.traffic, self.seed)
        self.train_step = make_train_step(self.cfg, eta=self.eta,
                                          federated=True)
        x0 = self.params = self._weights()
        self.prog = []
        for _ in range(self.check_steps):
            rec = self._round()
            rec["change"] = change_norms(self.params, x0)
            self.prog.append(rec)
        del x0
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _round(self):
        """One FedCGD round of the program; returns its record (the
        round's inputs, schedule and metrics)."""
        from repro_torch.core import Problem, fscd
        from repro_torch.fl.distributed import silo_weights
        w = self.world
        toks, hist = w.next_round()
        t0 = time.perf_counter()
        sched = fscd(Problem(
            p_dev=hist, global_dist=w.global_hist,
            class_weights=np.ones(w.classes), sigma=1.0,
            batch_size=w.batch * w.seq, min_bw=np.ones(w.silos),
            total_bw=float(w.silos)))
        self.sched_s.append(time.perf_counter() - t0)
        dev_toks = torch.from_numpy(toks).to(self.device)
        sw = silo_weights(sched.mask, w.silos).repeat_interleave(
            w.batch).to(self.device)
        self.params, metrics = self.train_step(
            self.params, {"tokens": dev_toks[:, :-1],
                          "targets": dev_toks[:, 1:],
                          "schedule_weights": sw})
        self.tokens.append(toks.shape[0] * (toks.shape[1] - 1))
        return {"toks": toks, "hist": hist, "mask": sched.mask.copy(),
                "metrics": metrics}

    # ------------------------------------------------------------------
    def step(self):
        self._round()
        return self.tokens[-1]

    def finish(self):
        self._sync()

    def layer_data(self, steps):
        from portbench import devtrace
        n = len(steps)
        out = {"schedule_s": self.sched_s[-n:], "trace": None}
        if self.device.type == "cuda":
            out["trace"] = devtrace.capture(self.step, self.trace_steps,
                                            LM_KERNELS)
        return out

    # ------------------------------------------------------------------
    def release(self):
        for name in ("params", "train_step"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _replay(self, rnd=None, fault=None):
        """The reference over the recorded rounds' inputs: per round its
        schedule, loss, grad norm and the model's change from the start
        (``fault``: "half", the loss over the first half of the rows;
        "answer", the first silo's schedule bit flipped)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        w, m = self.world, self.model_p
        x0 = self._weights()
        params = x0
        out = []
        for rec in self.prog:
            mask = fedcgd.fscd(rec["hist"], w.global_hist,
                               np.ones(w.classes), 1.0, w.batch * w.seq,
                               np.ones(w.silos), float(w.silos))
            if fault == "answer":
                mask[0] = not mask[0]
            wt = ref.silo_weights(mask, w.batch)
            if fault == "half":
                wt[len(wt) // 2:] = 0.0     # the weighted mean of the rest
            toks = torch.from_numpy(rec["toks"]).to(self.device)
            loss, g = ref.loss_and_grads(
                params, m, toks, torch.from_numpy(wt).to(self.device), rnd)
            gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(x)) ** 2
                                  for _, x in ref._flat(g)))
            new = ref.sgd(params, g, self.eta)
            rec = {"mask": mask, "loss": loss, "grad_norm": gnorm,
                   "change": change_norms(new, x0)}
            if not out:
                rec["held"] = held_share(new, params, g, self.eta)
            params = new
            del g
            out.append(rec)
        del params, x0
        return out

    def numbers(self, side=None):
        """The program's record (or, with ``side``, the reference so
        changed in the program's place) against the reference's:
        ``schedule`` (schedule bits that differ, exact), ``loss`` (each
        round's loss, worst relative gap), ``grad_norm`` (the first step's,
        the program's own metric), ``held_grad`` and ``held_change`` (the
        median leaf gap of the first change and of the change over all the
        rounds, over the leaves whose state holds the reference's step),
        and ``grad`` and ``change`` (the same by the worst of all leaves,
        read for PERF.md, not compared)."""
        if getattr(self, "_ref", None) is None:
            self._ref = self._replay()
        r = self._ref
        p = self._replay(**side) if side is not None else [
            {"mask": x["mask"], "loss": float(x["metrics"]["loss"]),
             "grad_norm": float(x["metrics"]["grad_norm"]),
             "change": x["change"]} for x in self.prog]
        keys = compare.kept(r[0]["change"])
        gaps = compare.leaf_gaps(p[0]["change"], r[0]["change"], keys)
        self.worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
        held = [k for k in keys if r[0]["held"][k] <= HELD]
        held_gaps = compare.leaf_gaps(p[0]["change"], r[0]["change"], held)
        self.held = len(held)
        return {
            "held_grad": compare.median(held_gaps),
            "held_change": compare.median(compare.leaf_gaps(
                p[-1]["change"], r[-1]["change"], held)),
            "schedule": float(sum(int((a["mask"] != b["mask"]).sum())
                                  for a, b in zip(p, r))),
            "loss": max(compare.rel(a["loss"], b["loss"])
                        for a, b in zip(p, r)),
            "grad_norm": compare.rel(p[0]["grad_norm"], r[0]["grad_norm"]),
            "grad": compare.leaf_gap(p[0]["change"], r[0]["change"], keys),
            "change": compare.leaf_gap(p[-1]["change"], r[-1]["change"],
                                       keys)}

    def check(self):
        self.release()
        nums = self.numbers()
        return [(k, nums[k], float(self.limits[k])) for k in self.limits]

    CONTROL = {"rnd": ref.fp8}
    FAULTS = {"half": {"fault": "half"}, "answer": {"fault": "answer"}}
