"""Driver ``lm_silos_moe``: ``lm_silos``' FedCGD over LM silos on
moonlight-16b-a3b (latent attention, a dense first layer, 26 MoE layers
of which this chip holds experts [expert_lo, expert_lo + experts_held)).

Beside ``lm_silos``: the weights are ``traffic/moonlight_weights.py``'s,
the reference ``reference/moonlight.py``, the recorded rounds keep the
program's expert choices (``train_step(..., routing=[])``), which the
sound reference replays, and the compared numbers add ``flip_gap``: the
largest gap between the reference's own k-th and (k+1)-th biased score
at a token where the program chose otherwise.  A side in the program's
place (the control, a planted fault) is a reference that routes by
itself: its choices are recorded, and the sound reference replays them
(``numbers``).  The traced steps keep their
``moe_tokens_held`` (device tensors read after the window) for the
grouped products' operation count.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.harness import BENCH, load_module, subseed
from portbench.reference import fedcgd
from portbench.reference import moonlight as ref
from portbench.reference import rwkv6 as ref6
from portbench.traffic.moonlight_weights import moonlight

_lm = load_module(BENCH / "drivers" / "lm_silos.py")

MOE_KERNELS = {"attention": ["flash_wgmma"],
               "attention_bwd": ["attn_bwd_dq_wgmma", "attn_bwd_dkv_wgmma"]}


class Driver(_lm.Driver):

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.step_metrics = []

    def _weights(self):
        gen = torch.Generator(device=self.device).manual_seed(
            subseed(self.seed, "weights"))
        return moonlight(gen, self.model_p, self.device)

    def setup(self):
        from portbench.traffic.lm_silos import SiloWorld
        from repro_torch.fl.distributed import make_train_step
        self.cfg = self._cfg()
        self.world = SiloWorld(self.cfg.vocab_size, self.traffic, self.seed)
        self.train_step = make_train_step(self.cfg, eta=self.eta,
                                          federated=True)
        x0 = self.params = self._weights()
        self.prog = []
        for _ in range(self.check_steps):
            routing = []
            rec = self._round(routing)
            rec["routing"] = [r.cpu() for r in routing]
            rec["change"] = _lm.change_norms(self.params, x0)
            self.prog.append(rec)
        del x0
        self._sync()

    def _round(self, routing=None):
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
                          "schedule_weights": sw}, routing=routing)
        self.tokens.append(toks.shape[0] * (toks.shape[1] - 1))
        return {"toks": toks, "hist": hist, "mask": sched.mask.copy(),
                "metrics": metrics}

    def step(self):
        self.step_metrics.append(self._round()["metrics"])
        del self.step_metrics[:-self.trace_steps]
        return self.tokens[-1]

    def layer_data(self, steps):
        from portbench import devtrace
        n = len(steps)
        out = {"schedule_s": self.sched_s[-n:], "trace": None}
        if self.device.type == "cuda":
            out["trace"] = devtrace.capture(self.step, self.trace_steps,
                                            MOE_KERNELS)
        traced = self.step_metrics[-self.trace_steps:]
        out["moe_tokens_held"] = [int(m["moe_tokens_held"]) for m in traced]
        out["moe_load_max"] = [int(m["moe_load_max"]) for m in traced]
        return out

    def _replay(self, rnd=None, fault=None, choices=None, ran=None):
        """The reference over the recorded rounds' inputs (module
        docstring of ``lm_silos``).  It routes by ``choices`` (a list of
        [T, k] a MoE layer, one list a recorded round) where given, else
        by itself; the sound reference (no ``rnd``, no ``fault``) replays
        the program's choices unless given others.  Each round keeps the
        choices it routed by and, where it replayed them, ``flip_gap``.
        Faults: ``lm_silos``' "half" and "answer", and
        ``reference/moonlight.py``'s "drop", "nobias" and "noscale".
        ``ran``: a replay already made, returned as it is."""
        if ran is not None:
            return ran
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        w, m = self.world, self.model_p
        if rnd is None and fault is None and choices is None:
            choices = [rec["routing"] for rec in self.prog]
        x0 = self._weights()
        params = x0
        out = []
        for i, rec in enumerate(self.prog):
            mask = fedcgd.fscd(rec["hist"], w.global_hist,
                               np.ones(w.classes), 1.0, w.batch * w.seq,
                               np.ones(w.silos), float(w.silos))
            if fault == "answer":
                mask[0] = not mask[0]
            wt = ref6.silo_weights(mask, w.batch)
            if fault == "half":
                wt[len(wt) // 2:] = 0.0
            toks = torch.from_numpy(rec["toks"]).to(self.device)
            ch = None if choices is None else choices[i]
            loss, g, logs = ref.loss_and_grads(
                params, m, toks, torch.from_numpy(wt).to(self.device), rnd,
                ch, fault if fault in ("drop", "nobias", "noscale") else None)
            gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(x)) ** 2
                                  for _, x in ref6._flat(g)))
            new = ref6.sgd(params, g, self.eta)
            r = {"mask": mask, "loss": loss, "grad_norm": gnorm,
                 "change": _lm.change_norms(new, x0),
                 "choices": [c.cpu() for c, _, _ in logs]}
            if ch is not None:
                r["flip_gap"] = ref.flip_gap(logs, ch)
            if not out:
                r["held"] = _lm.held_share(new, params, g, self.eta)
            params = new
            del g, logs
            out.append(r)
        del params, x0
        return out

    def numbers(self, side=None):
        """``lm_silos``' numbers and ``flip_gap``: the largest, over the
        recorded rounds, of the gaps the sound reference reads where it
        replays a choice it would not make itself.  The program is held to
        the sound reference replaying the program's choices.  A side put
        in the program's place (the control, a fault) routes by itself,
        and is held to the sound reference replaying the side's choices,
        as the program would be."""
        if side is None:
            nums = super().numbers()
            nums["flip_gap"] = max(x["flip_gap"] for x in self._ref)
            return nums
        ran = self._replay(**side)
        prog_ref = getattr(self, "_ref", None)
        self._ref = self._replay(choices=[x["choices"] for x in ran])
        try:
            nums = super().numbers({"ran": ran})
            nums["flip_gap"] = max(x["flip_gap"] for x in self._ref)
        finally:
            self._ref = prog_ref
        return nums

    CONTROL = {"rnd": ref6.fp8}
    FAULTS = {"half": {"fault": "half"}, "answer": {"fault": "answer"},
              "drop": {"fault": "drop"}, "nobias": {"fault": "nobias"},
              "noscale": {"fault": "noscale"}}
