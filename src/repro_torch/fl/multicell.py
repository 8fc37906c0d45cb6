"""Multi-cell round engine: C independent cells per aggregation step.

``repro.fl.multicell`` ported.  The paper evaluates P1 per cell per
round; a deployment runs many cells at once (one edge server each).
``MultiCellTrainer`` simulates C independent ``FederatedTrainer``
cells — separate seeds, channel geometries, model replicas, fault
streams — but runs every round phase *batched across cells*, so a
C-cell round costs a number of host syncs and scheduling calls that
does not grow with C:

  * prep: availability, channel, batch and dropout draws still come
    from each cell's own streams (bitwise-identical to standalone
    cells), but the channel math (path loss, shadow fold, Eq. 9
    bandwidths) runs once over stacked [C, V] arrays
    (``repro_torch.wireless.channel.draw_gains_batch``,
    ``repro_torch.faults.FaultInjector.draw_many``);
  * local update: ONE call of the shared round core
    (``repro_torch.fl.client.make_round_core``) with leading axes
    [cell, device, tau] computes every cell's local SGD, Eq. 10 sigmas
    (one ``persample_gradnorm`` launch for every device of every cell),
    deltas, delta norms and NaN/Inf flags, pulled in one device->host
    copy; model params stay stacked [C, ...] across rounds;
  * scheduling: ONE batched ``solve_many`` over the C per-cell P1
    instances, padded to a common device count through a cached pad
    layout (the torch backend's K1/K2 launches then cover every cell);
  * finalize: ONE call of the shared finalize core
    (``repro_torch.fl.server.make_finalize_core``) runs every cell's
    Eq. 2 aggregation and Eq. 12 deviation norms with the upload masks
    as a [C, V] weight matrix, and one host pull of the [C, V] norms
    feeds every cell's sigma-hat / G-hat refresh.

Host-sync contract: a fault-free round makes exactly 2 device->host
syncs for the WHOLE C-cell round (core outputs + finalize norms),
counted by ``last_round_host_syncs`` (per-cell counters only tick on
fault-path work such as corrupt-delta screening; evaluation pulls on
``eval_every`` rounds are not counted).

Cells are *padded, not truncated*: a cell with fewer available devices
than the round's most repeats its first device's batch and dropout
masks (computed, then ignored) and pads its P1 instance with
zero-distribution, infeasible (``min_bw = -1``) device rows that no
solver schedules.  With ``num_cells = 1`` nothing is padded and every
call is the one ``FederatedTrainer`` makes, so the single-cell history
is reproduced bitwise; with full availability every cell of a C>1 run
equals a standalone trainer bitwise.

Faulty rounds may make one extra batched ``solve_many`` for the cells
that back-fill failed uploads; fault-free rounds make exactly one
(``solve_many_calls`` counts them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import scheduling as S
from repro_torch.core.bandwidth import min_bandwidth
from repro_torch.data.datasets import ArrayDataset
from repro_torch.faults.injector import FaultInjector
from repro_torch.fl.rounds import FederatedTrainer, FLConfig
from repro_torch.models.registry import Model
from repro_torch.obs import ObsConfig
from repro_torch.obs import from_config as obs_from_config
from repro_torch.wireless.channel import (draw_gains_batch,
                                          received_power_batch)

# schedulers with a batched solve_many implementation
MULTICELL_SCHEDULERS = ("fedcgd-fscd", "fedcgd-gs", "fedcgd-fscd-gc")


def _pad_batches(batches, pad: int):
    """Grow the device axis of every leaf (a dict of batches or a tuple
    of dropout masks) by ``pad`` rows repeating device 0 (the rows are
    computed and discarded; repeating a real batch keeps the padded
    lanes numerically tame)."""
    if pad == 0:
        return batches

    def grow(x):
        return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
    if isinstance(batches, dict):
        return {k: grow(x) for k, x in batches.items()}
    return tuple(grow(x) for x in batches)


class _PadCache:
    """Cached ``solve_many`` pad layout.

    P1 instances are padded to a common device count with
    zero-distribution, infeasible (``min_bw = -1``) rows: the solvers
    never schedule them, and real-device decisions are unchanged
    (candidate values are computed per device; infeasible rows rank as
    +inf).  The pad layout only depends on (batch slot, vmax, classes),
    so the float64 buffers are kept across calls and only rewritten in
    place."""

    def __init__(self):
        self._bufs = {}

    def pad(self, probs: Sequence[S.Problem]) -> List[S.Problem]:
        vmax = max(p.num_devices for p in probs)
        out = []
        for slot, p in enumerate(probs):
            V = p.num_devices
            if V == vmax:
                out.append(p)
                continue
            p_dev = np.asarray(p.p_dev)
            key = (slot, vmax, p_dev.shape[1])
            bufs = self._bufs.get(key)
            if bufs is None:
                bufs = (np.zeros((vmax, p_dev.shape[1])),
                        np.full(vmax, -1.0))
                self._bufs[key] = bufs
            pb, bb = bufs
            pb[:V] = p_dev
            pb[V:] = 0.0
            bb[:V] = np.asarray(p.min_bw, np.float64)
            bb[V:] = -1.0
            out.append(dataclasses.replace(p, p_dev=pb, min_bw=bb))
        return out


def _pad_problems(probs: Sequence[S.Problem]) -> List[S.Problem]:
    """One-shot padding (uncached) — see ``_PadCache``."""
    return _PadCache().pad(probs)


def _slice_schedule(sched: S.Schedule, n: int) -> S.Schedule:
    """Drop the padded device rows from a batched solve (they are never
    scheduled, so the counts and the objective are unaffected)."""
    if len(sched.mask) == n:
        return sched
    return dataclasses.replace(sched, mask=sched.mask[:n])


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


class MultiCellTrainer:
    """C ``FederatedTrainer`` cells advanced in lock-step: one round-core
    call, one batched scheduling call and one finalize call per
    aggregation step — host syncs constant in C."""

    def __init__(self, model: Model, train: ArrayDataset,
                 test: ArrayDataset, device_indices, cfg: FLConfig,
                 cell_seeds: Optional[Sequence[int]] = None):
        if cfg.scheduler not in MULTICELL_SCHEDULERS:
            raise ValueError(
                f"MultiCellTrainer requires a batched scheduler "
                f"{MULTICELL_SCHEDULERS}, got {cfg.scheduler!r}")
        C = cfg.num_cells
        if C < 1:
            raise ValueError(f"num_cells must be >= 1, got {C}")
        if cell_seeds is None:
            cell_seeds = [cfg.seed + c for c in range(C)]
        if len(cell_seeds) != C:
            raise ValueError(f"need {C} cell seeds, got {len(cell_seeds)}")
        # one shared device partition, or one partition per cell
        per_cell = (isinstance(device_indices, (list, tuple))
                    and len(device_indices) == C
                    and isinstance(device_indices[0], (list, tuple)))
        parts = (list(device_indices) if per_cell
                 else [device_indices] * C)

        self.cfg = cfg
        # the engine owns observability: cells are built silent (their
        # ``obs`` is the no-op facade) so C cells never open C sinks
        self.obs = obs_from_config(cfg.obs)
        cell_cfg = dataclasses.replace(cfg, obs=ObsConfig())
        self.cells: List[FederatedTrainer] = [
            FederatedTrainer(model, train, test, parts[c],
                             dataclasses.replace(cell_cfg,
                                                 seed=cell_seeds[c]))
            for c in range(C)]
        for c, cell in enumerate(self.cells):
            cell.faults.obs = self.obs     # injected-fault counters
            cell._eval_obs = self.obs      # evaluation's span
            cell._eval_tags = {"cell": c}
        self.device = self.cells[0].device
        # every cell runs the same architecture: share cell 0's cores so
        # C=1 runs exactly the calls FederatedTrainer makes
        self._core = self.cells[0]._round_core
        for cell in self.cells[1:]:
            cell._round_core = self.cells[0]._round_core
            cell._sigma_all = self.cells[0]._sigma_all
            cell._finalize_core = self.cells[0]._finalize_core
        self._finalize_core = self.cells[0]._finalize_core
        # params stay stacked [C, ...] across rounds (the round core and
        # finalize consume and produce the stack); cells hold views
        self._params_c = _stack([cell.params for cell in self.cells])
        self._pad_cache = _PadCache()
        self._algorithm = "gs" if cfg.scheduler == "fedcgd-gs" else "fscd"
        self.solve_many_calls = 0        # scheduling calls issued
        self.last_round_host_syncs = 0   # device->host pulls for the
        #   WHOLE C-cell round (contract: <= 3 fault-free, const in C)
        self.history: List[List[Dict]] = []

    @property
    def num_cells(self) -> int:
        return len(self.cells)

    # ------------------------------------------------------------------
    def _solve_batch(self, probs: Sequence[S.Problem]) -> List[S.Schedule]:
        self.solve_many_calls += 1
        return S.solve_many(self._pad_cache.pad(probs), self._algorithm,
                            backend=self.cfg.scheduler_backend,
                            obs=self.obs, device=self.device)

    def _apply_mods_batched(self, dev_params_c, deltas_c, states):
        """Scatter every cell's sanitizer replacements (clipped /
        corrupted-but-kept uploads) into the stacked [C, V, ...] trees —
        one (cell, device) scatter per leaf; no-op on clean rounds."""
        mods = [(c, i, d) for c, st in enumerate(states)
                for i, d in st.mod_deltas.items() if st.upload[i]]
        if not mods:
            return dev_params_c, deltas_c
        cs = torch.tensor([m[0] for m in mods], device=self.device)
        vs = torch.tensor([m[1] for m in mods], device=self.device)
        repl = _stack([m[2] for m in mods])
        deltas_c = {k: s.index_put((cs, vs), repl[k].to(s.dtype))
                    for k, s in deltas_c.items()}
        dev_params_c = {
            k: s.index_put((cs, vs),
                           (self._params_c[k][cs] + repl[k]).to(s.dtype))
            for k, s in dev_params_c.items()}
        return dev_params_c, deltas_c

    def run_round(self, j: int) -> List[Dict]:
        obs = self.obs
        with obs.span("round"):
            recs = self._run_round_phases(j)
        if obs.enabled:
            self._emit_round_obs(j, recs)
        return recs

    def _run_round_phases(self, j: int) -> List[Dict]:
        """One C-cell round, every phase under an engine-level ``obs``
        span tagged with the cell count (no-op singletons when off)."""
        cells = self.cells
        C = len(cells)
        cfg = self.cfg
        obs = self.obs
        self.last_round_host_syncs = 0
        for cell in cells:
            cell.last_round_host_syncs = 0
            cell.last_round_eval_syncs = 0

        # host-side prep: availability / channel / batch / dropout draws
        # stay on each cell's own streams, the channel math runs once
        # over [C, V] stacks
        with obs.span("prep", cells=C):
            avails = [cell._draw_avail() for cell in cells]
            cell_states = [cell.cell for cell in cells]
            gains_cv = draw_gains_batch(cell_states,
                                        [cell.rng for cell in cells])
            rx_cv = received_power_batch(cell_states, gains_cv)
            noise = np.array([cs.params.noise_psd_w
                              for cs in cell_states])[:, None]
            bstar_cv = min_bandwidth(cells[0].payload, cfg.deadline_s,
                                     rx_cv, noise)
            preps = [cell._prep_from_channel(j, av, ai, gains_cv[c],
                                             bstar_cv[c])
                     for c, (cell, (av, ai))
                     in enumerate(zip(cells, avails))]
            n_av = [len(p.avail_idx) for p in preps]
            vmax = max(n_av)

        # ONE round-core call over [C, Vmax, ...], then one host pull of
        # every scheduling input
        with obs.span("core", cells=C):
            batches_c = _stack([_pad_batches(p.batches, vmax - n)
                                for p, n in zip(preps, n_av)])
            dropout_c = tuple(
                torch.stack(ms) for ms in zip(*[
                    _pad_batches(p.dropout, vmax - n)
                    for p, n in zip(preps, n_av)]))
            dev_params_c, losses_c, sigma_c, deltas_c, norms_c, fin_c = \
                self._core(self._params_c, batches_c, dropout_c)
            lh, sh, nh, fh = torch.stack([
                losses_c, sigma_c, norms_c,
                fin_c.to(torch.float32)]).cpu().numpy()
            fh = fh > 0.5
            self.last_round_host_syncs += 1

        with obs.span("schedule", cells=C):
            probs, losses64, norms64 = [], [], []
            for c, (cell, prep, n) in enumerate(zip(cells, preps, n_av)):
                dev_losses = np.asarray(lh[c, :n], dtype=np.float64)
                losses64.append(dev_losses)
                norms64.append(np.asarray(nh[c, :n], dtype=np.float64))
                cell._post_core(prep, dev_losses,
                                np.asarray(sh[c, :n], dtype=np.float64))
                probs.append(cell._make_problem(prep))
            # ONE scheduling call for all C cells (cached pad layout)
            scheds = [_slice_schedule(s, n)
                      for s, n in zip(self._solve_batch(probs), n_av)]

        # upload phase per cell: fault draws batched, NaN/Inf flags from
        # the core, per-cell delta slices only for fault-bearing configs
        with obs.span("upload", cells=C):
            rfs = FaultInjector.draw_many(
                [cell.faults for cell in cells], j)
            need_deltas = (any(cell.faults.enabled for cell in cells)
                           or cfg.faults.clip_delta_norm > 0)
            deltas_cell = [None] * C
            if need_deltas:
                deltas_cell = [{k: x[c] for k, x in deltas_c.items()}
                               for c in range(C)]
            states, bf_idx, bf_probs = [], [], []
            for c, (cell, prep, sched) in enumerate(zip(cells, preps,
                                                        scheds)):
                st = cell._upload_phase(j, prep, sched, deltas_cell[c],
                                        norms64[c],
                                        finite=fh[c, :n_av[c]],
                                        rf=rfs[c])
                states.append(st)
                if cell._wants_backfill(st, sched):
                    pb = cell._backfill_problem(probs[c], sched, st, prep)
                    if pb is not None:
                        bf_idx.append(c)
                        bf_probs.append(pb)
            # at most one extra batched call for the backfilling cells
            if bf_probs:
                for c, bf in zip(bf_idx, self._solve_batch(bf_probs)):
                    cells[c]._apply_backfill(
                        _slice_schedule(bf, n_av[c]), states[c], preps[c],
                        deltas_cell[c], norms64[c],
                        finite=fh[c, :n_av[c]])

        # ONE finalize call: Eq. 2 over the [C, V] upload weight matrix +
        # Eq. 12 deviation norms; zero-upload cells keep their params
        with obs.span("finalize", cells=C):
            w_cv = np.zeros((C, vmax), np.float32)
            active = np.zeros(C, bool)
            for c, (cell, st) in enumerate(zip(cells, states)):
                pad = vmax - n_av[c]
                if pad:     # padded rows enter Eq. 2 with weight 0 and
                    # are never G-refreshed
                    st.upload = np.concatenate(
                        [st.upload, np.zeros(pad, bool)])
                w_cv[c] = cell._finalize_weights(st.upload)
                active[c] = st.upload.any()
            dev_params_c, deltas_c = self._apply_mods_batched(
                dev_params_c, deltas_c, states)
            newp_c, norms_fc = self._finalize_core(
                self._params_c, dev_params_c, deltas_c,
                torch.from_numpy(w_cv).to(self.device), active)
            self._params_c = newp_c
            norms_h = norms_fc.cpu().numpy()
            self.last_round_host_syncs += 1

            recs = []
            for c, (cell, prep, sched, st) in enumerate(
                    zip(cells, preps, scheds, states)):
                cell.params = {k: x[c] for k, x in newp_c.items()}
                recs.append(cell._finalize_host(j, prep, sched, st,
                                                norms_h[c], losses64[c]))
        self.last_round_host_syncs += sum(
            cell.last_round_host_syncs for cell in cells)
        self.history.append(recs)
        return recs

    def _emit_round_obs(self, j: int, recs: List[Dict]) -> None:
        """Engine-level metrics + one ``multicell_round`` record (phase
        breakdown, host syncs) and one round record per cell."""
        m = self.obs.metrics
        C = len(self.cells)
        hs = self.last_round_host_syncs
        m.counter("fl.rounds_total").inc()
        m.counter("fl.host_syncs_total").inc(hs)
        m.gauge("fl.round.host_syncs").set(hs)
        m.gauge("fl.cells").set(C)
        uploads = sum(r["num_uploaded"] for r in recs)
        upload_bytes = uploads * self.cells[0].payload / 8.0
        m.counter("fl.uploads_total").inc(uploads)
        m.counter("fl.upload_bytes_total").inc(upload_bytes)
        m.gauge("fl.round.upload_bytes").set(upload_bytes)
        for rec in recs:
            for cause, n in rec["failure_causes"].items():
                if n:
                    m.counter(f"fl.failures.{cause}").inc(n)
        m.counter("fl.sanitized_total").inc(
            sum(r["num_sanitized"] for r in recs))
        m.counter("fl.clipped_total").inc(
            sum(r["num_clipped"] for r in recs))
        m.counter("fl.backfilled_total").inc(
            sum(r["num_backfilled"] for r in recs))
        m.counter("fl.g_refresh_errors_total").inc(
            sum(r["g_refresh_errors_round"] for r in recs))
        self.obs.round_record({
            "kind": "multicell_round", "round": j, "cells": C,
            "host_syncs": hs,
            "eval_syncs": sum(c.last_round_eval_syncs for c in self.cells),
            "num_uploaded": uploads,
            "upload_bytes": upload_bytes,
            "solve_many_calls": self.solve_many_calls,
        })
        for c, rec in enumerate(recs):
            self.obs.emit(dict(rec, kind="round", cell=c))

    # ------------------------------------------------------------------
    def run(self, num_rounds: int,
            verbose: bool = False) -> List[List[Dict]]:
        for j in range(num_rounds):
            recs = self.run_round(j)
            if verbose and ("test_accuracy" in recs[0]):
                accs = " ".join(f"{r['test_accuracy']:.3f}" for r in recs)
                print(f"round {j:4d} acc per cell: {accs}")
        return self.history
