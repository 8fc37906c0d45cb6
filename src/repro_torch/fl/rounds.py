"""FedCGD — Algorithm 3: the full federated round loop, in PyTorch.

Per round j:
  1. device availability ~ Bernoulli(p_a); channel gains drawn from the
     TR 38.901 cell -> minimum bandwidths B_v* (Eq. 9)
  2. edge broadcasts w^{(j)}; every available device runs tau local SGD
     steps (Eq. 1) — ``torch.func.vmap`` over the devices
  3. devices report sigma_v (Eq. 10) and p_v over the sampled data
  4. server solves P1 (GS / FSCD / FSCD-Gc or a baseline policy)
  5. scheduled devices upload — each upload can fail (dropout, compute
     straggling, a second shadow-fading draw breaking Eq. 9) or arrive
     corrupted; the server sanitizes deltas (NaN/Inf guard + norm
     clip), backfills failed slots by re-solving P1 over the surviving
     feasible devices with the residual bandwidth, and aggregates the
     uploads that actually landed (Eq. 2, weights renormalized)
  6. server refreshes G (Eq. 12) from the landed deltas; on a
     zero-upload round it skips aggregation and decays sigma-hat /
     G-hat toward their priors instead of freezing stale estimates

This is ``repro.fl.rounds`` ported: host-side numpy draws consume the
same streams in the same order, so on equal seeds and equal params the
two trainers take the same decisions.  The fault model lives in
``repro_torch.faults`` (inert by default) and ``repro_torch.obs``
(``FLConfig.obs``, off by default) adds round-phase spans and records.

The round hot path is *fused*: ``repro_torch.fl.client.make_round_core``
runs the local updates, the Eq. 10 sigma estimates, the deltas, their
L2 norms and NaN/Inf flags on the device, and the host pulls all
scheduling inputs in one device->host copy; the finalize core pulls the
Eq. 12 norms in a second one (``last_round_host_syncs`` counts the
pulls; a fault-free round makes 2).

Device rule: ``FLConfig.device=None`` means the GPU, and the trainer
raises when there is none; tests and CPU runs pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core import estimation as E
from repro_torch.core import scheduling as S
from repro_torch.core.bandwidth import min_bandwidth
from repro_torch.data.datasets import ArrayDataset
from repro_torch.data.partition import label_distributions
from repro_torch.device import resolve_device
from repro_torch.faults.config import FaultConfig
from repro_torch.faults.injector import FAILURE_CAUSES, FaultInjector
from repro_torch.faults.sanitize import sanitize_updates
from repro_torch.fl.client import make_round_core, payload_bits, set_devices
from repro_torch.fl.server import make_finalize_core
from repro_torch.models import cnn as C
from repro_torch.models.registry import Model
from repro_torch.obs import COUNT_BUCKETS, ObsConfig
from repro_torch.obs import from_config as obs_from_config
from repro_torch.wireless.channel import CellState, make_cell


@dataclasses.dataclass
class FLConfig:
    """One FL experiment (paper Table I + engine knobs).

    ``device`` is where the models, the round core and the torch
    scheduler run (None = the GPU).  The torch scheduler's f32
    candidate scans go through the ``wemd_add`` / ``wemd_swap`` kernels
    and the round core's Eq. 10 sigmas through one batched
    ``persample_gradnorm`` call: the kernels on a CUDA device, their
    plain versions on the CPU.  ``obs`` configures the observability
    layer, off by default."""
    num_devices: int = 64
    available_prob: float = 0.3
    batch_size: int = 32
    tau: int = 1
    eta: float = 0.1
    deadline_s: float = 2.0
    scheduler: str = "fedcgd-fscd"
    scheduler_backend: str = "numpy"     # "numpy" | "torch" (batched engine)
    device: Optional[str] = None
    poc_candidates: int = 16
    bits_per_param: int = 32
    payload_bits_override: float = 0.0   # 0 = derive from model size
    seed: int = 0
    sigma_init: float = 1.0
    g_init: float = 1.0
    eval_every: int = 5
    ucb_beta: float = 0.05
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)


SCHEDULERS = ("fedcgd-fscd", "fedcgd-gs", "fedcgd-fscd-gc", "fedcgd-cd",
              "bc", "bn", "poc", "fcbs", "random")


@dataclasses.dataclass
class RoundPrep:
    """Host-side round inputs (availability, channel, sampled batches)."""
    avail: np.ndarray          # [V] bool
    avail_idx: np.ndarray      # [V_av]
    gains: np.ndarray          # [V] scheduling-time channel gains
    bstar: np.ndarray          # [V] Eq. 9 minimum bandwidths
    batches: Dict              # tensors, leaves [V_av, tau, b, ...]
    p_sampled: np.ndarray      # [V_av, C] sampled label histograms
    dropout: tuple             # keep masks [V_av, tau, b, ...] (or ())


@dataclasses.dataclass
class UploadState:
    """Mutable upload-phase outcome threaded through backfill/aggregate."""
    upload: np.ndarray         # [V_av] bool — uploads entering Eq. 2
    mod_deltas: Dict           # local idx -> replacement delta tree
    cause_counts: Dict[str, int]
    arrived: np.ndarray        # [V_av] bool — pre-sanitize arrivals
    rf: object                 # RoundFaults
    upload_gains: np.ndarray   # [V] gains at upload time
    num_dropped_nf: int = 0
    num_clipped: int = 0
    num_bf_scheduled: int = 0
    num_backfilled: int = 0


class FederatedTrainer:
    def __init__(self, model: Model, train: ArrayDataset, test: ArrayDataset,
                 device_indices: List[np.ndarray], cfg: FLConfig,
                 cell: Optional[CellState] = None):
        if cfg.scheduler_backend not in ("numpy", "torch"):
            raise ValueError(
                f"unknown scheduler_backend: {cfg.scheduler_backend!r}")
        self.device = resolve_device(cfg.device)
        # f32 stays f32 on the card: cuDNN convolutions default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # same seed, same bits on the card: left to itself, cuDNN runs the
        # first layer's weight gradient in the vmapped (grouped)
        # convolutions of the local update with an algorithm that sums
        # by atomics, and rounds then differ from run to run (PERF.md)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.model = model
        self.train = train
        self.test = test
        self.device_indices = device_indices
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # dropout masks come from an explicit generator on the device
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed)
        self.cell = cell or make_cell(cfg.num_devices, self.rng)

        C_ = train.num_classes
        self.p_dev = label_distributions(train.labels, device_indices, C_)
        sizes = np.array([len(i) for i in device_indices], dtype=np.float64)
        self.dev_sizes = sizes
        all_idx = np.concatenate(device_indices)
        self.global_dist = np.bincount(train.labels[all_idx],
                                       minlength=C_) / len(all_idx)
        self.num_classes = C_

        init_gen = torch.Generator().manual_seed(cfg.seed + 1)
        self.params = {k: v.to(self.device)
                       for k, v in model.init(init_gen).items()}
        self.sigma_hat = cfg.sigma_init
        self.g_hat = cfg.g_init
        self.g_hat_c = np.full(C_, cfg.g_init)
        self.payload = (cfg.payload_bits_override
                        or payload_bits(self.params, cfg.bits_per_param))
        self.plays = np.zeros(cfg.num_devices)       # Fed-CBS counters
        self.cum_loss = np.zeros(cfg.num_devices)    # POC statistics
        self.history: List[Dict] = []
        # observability facade (the shared no-op DISABLED when off)
        self.obs = obs_from_config(cfg.obs)
        self.faults = FaultInjector(cfg.faults, cfg.num_devices, cfg.seed,
                                    obs=self.obs)
        self.g_refresh_errors = 0                    # cumulative Eq. 12 skips
        self._obs_sched_iters = 0                    # last round, for obs

        # instrument_jit is the identity when obs is disabled; enabled,
        # it counts calls per core
        self._round_core = self.obs.instrument_jit(
            "round_core", make_round_core(self.model.loss_fn,
                                          self._sigma_all, cfg.eta,
                                          cfg.tau))
        self._finalize_core = self.obs.instrument_jit(
            "finalize_core", make_finalize_core(cfg.tau, cfg.eta))
        self._eval_batch = self.obs.instrument_jit("eval", self._eval_fn)
        self.last_round_host_syncs = 0       # device->host pulls between
        #   local update and aggregation (fused round contract: <= 3)

        # single-class-per-device detection (enables FSCD-Gc)
        self.device_class = self.p_dev.argmax(axis=1)
        self.single_class = bool((self.p_dev.max(axis=1) > 0.999).all())

    # ------------------------------------------------------------------
    def _eval_fn(self, params, batch):
        return self.model.forward(params, batch).argmax(-1)

    def make_batch(self, inputs, labels):
        return {"images": torch.from_numpy(
                    np.ascontiguousarray(inputs, np.float32)).to(self.device),
                "labels": torch.from_numpy(
                    np.asarray(labels, np.int64)).to(self.device)}

    # ------------------------------------------------------------------
    def _device_batches(self, avail: np.ndarray):
        """Stacked batches [V_av, tau, b, ...] + per-device sampled label
        histograms (paper: p_v over the sampled data)."""
        cfg = self.cfg
        xs, ys, hists = [], [], []
        for v in np.flatnonzero(avail):
            idx = self.device_indices[v]
            take = self.rng.choice(idx, size=cfg.tau * cfg.batch_size,
                                   replace=len(idx) < cfg.tau * cfg.batch_size)
            xs.append(self.train.inputs[take])
            ys.append(self.train.labels[take])
            hists.append(np.bincount(self.train.labels[take],
                                     minlength=self.num_classes)
                         / len(take))
        x = np.stack(xs).reshape((len(xs), cfg.tau, cfg.batch_size)
                                 + xs[0].shape[1:])
        y = np.stack(ys).reshape(len(ys), cfg.tau, cfg.batch_size)
        # one host->device copy per leaf for all devices
        return self.make_batch(x, y), np.stack(hists)

    def _draw_dropout(self, num_avail: int) -> tuple:
        """Keep masks [V_av, tau, b, ...] for every dropout layer, from the
        trainer's generator (() when the model has no dropout)."""
        cfg = self.cfg
        out = []
        for shape, rate in zip(self.model.dropout_shapes(cfg.batch_size),
                               C.DROPOUT_RATES):
            u = torch.rand((num_avail, cfg.tau) + tuple(shape),
                           generator=self.gen, device=self.device)
            out.append(u < 1.0 - rate)
        return tuple(out)

    def _sigma_all(self, params, images, labels):
        """Eq. 10 for the classifier head on every device's first batch
        at once, through the ``persample_gradnorm`` kernel: images
        [V, b, ...], labels [V, b] -> [V]."""
        V, b = labels.shape
        feats, logits = _cnn_features_logits(
            params, self.model.cfg, images.reshape((V * b,) + images.shape[2:]))
        return E.sigma_hat_lastlayer(feats.reshape(V, b, -1),
                                     logits.reshape(V, b, -1), labels,
                                     use_kernel=True)

    # ------------------------------------------------------------------
    def _schedule(self, prob: S.Problem, avail_idx, gains, delta_norms,
                  round_idx) -> S.Schedule:
        cfg = self.cfg
        name = cfg.scheduler
        torch_backend = cfg.scheduler_backend == "torch"
        if name in ("fedcgd-gs", "fedcgd-fscd", "fedcgd-fscd-gc"):
            alg = "gs" if name == "fedcgd-gs" else "fscd"
            if torch_backend:
                return S.solve_many([prob], alg, backend="torch",
                                    obs=self.obs, device=self.device)[0]
            return S.greedy_scheduling(prob) if alg == "gs" \
                else S.fscd(prob)
        if name == "fedcgd-cd":
            return S.coordinate_descent(prob, self.rng)
        if name == "bc":
            return S.best_channel(prob, gains[avail_idx])
        if name == "bn":
            return S.best_norm(prob, delta_norms)
        if name == "poc":
            return S.power_of_choice(prob, self.cum_loss[avail_idx],
                                     cfg.poc_candidates, self.rng)
        if name == "fcbs":
            return S.fed_cbs(prob, self.plays[avail_idx], round_idx,
                             cfg.ucb_beta, self.rng)
        if name == "random":
            return S.random_schedule(prob, self.rng)
        raise ValueError(name)

    # ------------------------------------------------------------------
    def _corrupt_overrides(self, rf, arrived, avail_idx, deltas) -> Dict:
        """Replacement deltas for uploads damaged in transit."""
        out = {}
        if not (self.faults.enabled and self.cfg.faults.corrupt_prob > 0):
            return out
        for i in np.flatnonzero(arrived):
            v = avail_idx[i]
            if rf.corrupt[v]:
                out[int(i)] = self.faults.corrupt_delta(
                    {k: x[i] for k, x in deltas.items()},
                    self.faults.corrupt_mode_of(rf, v))
        return out

    def _backfill_problem(self, prob, sched, st: UploadState,
                          prep: RoundPrep) -> Optional[S.Problem]:
        """One-shot reschedule after upload failures: the P1 instance
        over the surviving feasible devices (available, unscheduled, not
        dropped out) under the residual bandwidth, at upload-time gains.
        Returns None when no residual bandwidth / no feasible device."""
        cfg = self.cfg
        avail_idx = prep.avail_idx
        residual = self.cell.params.total_bandwidth_hz \
            - float(prep.bstar[avail_idx[st.arrived]].sum())
        if residual <= 0:
            return None
        bf_bw = min_bandwidth(
            self.payload, cfg.deadline_s,
            self.cell.received_power(st.upload_gains),
            self.cell.params.noise_psd_w)[avail_idx]
        blocked = sched.mask | st.rf.dropout[avail_idx]
        bf_bw = np.where(blocked, -1.0, bf_bw)
        if not ((bf_bw > 0) & (bf_bw <= residual)).any():
            return None
        return dataclasses.replace(prob, min_bw=bf_bw, total_bw=residual)

    def _apply_backfill(self, bf: S.Schedule, st: UploadState,
                        prep: RoundPrep, deltas, delta_norms,
                        finite=None) -> None:
        """Fold a solved backfill schedule into the upload state.

        Backfilled uploads are treated as freshly channel-measured (no
        second outage draw) but still face corruption + sanitization."""
        if not bf.mask.any():
            return
        avail_idx = prep.avail_idx
        self.plays[avail_idx[bf.mask]] += 1
        overrides = self._corrupt_overrides(st.rf, bf.mask, avail_idx,
                                            deltas)
        san = sanitize_updates(deltas, np.flatnonzero(bf.mask), overrides,
                               self.cfg.faults.clip_delta_norm,
                               norms=delta_norms, finite=finite)
        if finite is None or overrides:
            self.last_round_host_syncs += 1
        st.cause_counts["corrupt"] += len(san.dropped_nonfinite)
        st.num_bf_scheduled += int(bf.num_scheduled)
        st.num_dropped_nf += len(san.dropped_nonfinite)
        st.num_clipped += len(san.clipped)
        st.num_backfilled += len(san.kept)
        st.mod_deltas.update(san.deltas)
        st.upload[san.kept] = True

    # ------------------------------------------------------------------
    # round phases

    def _draw_avail(self):
        """Device availability ~ Bernoulli(p_a), forced non-empty."""
        cfg = self.cfg
        avail = self.rng.random(cfg.num_devices) < cfg.available_prob
        if not avail.any():
            avail[self.rng.integers(cfg.num_devices)] = True
        return avail, np.flatnonzero(avail)

    def _prep_from_channel(self, j: int, avail: np.ndarray,
                           avail_idx: np.ndarray, gains: np.ndarray,
                           bstar: np.ndarray) -> RoundPrep:
        """Sampled batches + dropout masks for a given availability and
        channel realisation (the RNG tail of ``_prepare_round``)."""
        batches, p_sampled = self._device_batches(avail)
        return RoundPrep(avail=avail, avail_idx=avail_idx, gains=gains,
                         bstar=bstar, batches=batches, p_sampled=p_sampled,
                         dropout=self._draw_dropout(len(avail_idx)))

    def _prepare_round(self, j: int) -> RoundPrep:
        """Host-side round inputs: availability, channel, Eq. 9
        bandwidths, sampled batches, dropout masks."""
        cfg = self.cfg
        avail, avail_idx = self._draw_avail()
        gains = self.cell.draw_gains(self.rng)
        rx_power = self.cell.received_power(gains)
        bstar = min_bandwidth(self.payload, cfg.deadline_s, rx_power,
                              self.cell.params.noise_psd_w)
        return self._prep_from_channel(j, avail, avail_idx, gains, bstar)

    def _post_core(self, prep: RoundPrep, dev_losses: np.ndarray,
                   sigma_v: np.ndarray) -> None:
        """Fold the round core's host pulls into the running estimates
        (POC loss statistics, Eq. 11 global sigma)."""
        self.cum_loss[prep.avail_idx] = (0.9 * self.cum_loss[prep.avail_idx]
                                         + dev_losses)
        alpha_av = np.ones(len(prep.avail_idx)) / len(prep.avail_idx)
        self.sigma_hat = E.sigma_hat_global(sigma_v, alpha_av)

    def _make_problem(self, prep: RoundPrep) -> S.Problem:
        cfg = self.cfg
        cw = (self.g_hat_c if cfg.scheduler == "fedcgd-fscd-gc"
              else np.full(self.num_classes, self.g_hat))
        return S.Problem(
            p_dev=prep.p_sampled, global_dist=self.global_dist,
            class_weights=cw, sigma=self.sigma_hat,
            batch_size=cfg.batch_size, min_bw=prep.bstar[prep.avail_idx],
            total_bw=self.cell.params.total_bandwidth_hz)

    def _upload_phase(self, j: int, prep: RoundPrep, sched: S.Schedule,
                      deltas, delta_norms, finite=None,
                      rf=None) -> UploadState:
        """Fault injection + server-side sanitization for one round's
        scheduled uploads (backfill is the caller's second pass).

        ``finite`` carries the round core's per-device NaN/Inf-guard
        flags (no sanitizer device round-trip when provided); ``rf``
        a pre-drawn fault realisation."""
        cfg = self.cfg
        avail_idx = prep.avail_idx
        mask_global = np.zeros(cfg.num_devices, bool)
        mask_global[avail_idx[sched.mask]] = True
        self.plays[mask_global] += 1

        inj = self.faults
        if rf is None:
            rf = inj.draw(j)
        upload_gains = inj.upload_gains(prep.gains, rf)
        cause = inj.arrival_failures(
            rf, mask_global, prep.bstar, self.payload, cfg.deadline_s,
            self.cell.received_power(upload_gains),
            self.cell.params.noise_psd_w)
        cause_counts = {c: 0 for c in FAILURE_CAUSES}
        arrived = sched.mask.copy()             # local (avail) index space
        for i in np.flatnonzero(sched.mask):
            c = cause[avail_idx[i]]
            if c:
                arrived[i] = False
                cause_counts[c] += 1

        # sanitize arrived uploads (NaN/Inf guard + norm clip)
        overrides = self._corrupt_overrides(rf, arrived, avail_idx, deltas)
        san = sanitize_updates(deltas, np.flatnonzero(arrived), overrides,
                               cfg.faults.clip_delta_norm,
                               norms=delta_norms, finite=finite)
        if arrived.any() and (finite is None or overrides):
            self.last_round_host_syncs += 1
        cause_counts["corrupt"] += len(san.dropped_nonfinite)
        upload = np.zeros_like(sched.mask)
        upload[san.kept] = True
        return UploadState(
            upload=upload, mod_deltas=san.deltas,
            cause_counts=cause_counts, arrived=arrived, rf=rf,
            upload_gains=upload_gains,
            num_dropped_nf=len(san.dropped_nonfinite),
            num_clipped=len(san.clipped))

    def _wants_backfill(self, st: UploadState, sched: S.Schedule) -> bool:
        return (self.faults.enabled and self.cfg.faults.backfill
                and int(st.upload.sum()) < sched.num_scheduled)

    def _finalize_weights(self, upload: np.ndarray) -> np.ndarray:
        """Eq. 2 weight row for the fused finalize core: upload_v / |U|
        as f32.  The same values serve as the Eq. 12 centering alphas
        (both are 1/|U| on uploaded rows, 0 elsewhere)."""
        w = np.asarray(upload, np.float64)
        return (w / max(w.sum(), 1.0)).astype(np.float32)

    def _apply_mods(self, dev_params, deltas, st: UploadState):
        """Scatter sanitizer replacements (clipped / corrupted-but-kept
        uploads) into the stacked [V, ...] trees — one scatter per leaf;
        no-op (bitwise) on clean rounds."""
        mod = {i: d for i, d in st.mod_deltas.items() if st.upload[i]}
        if not mod:
            return dev_params, deltas
        idx = np.fromiter(mod.keys(), dtype=np.int64)
        repl = {k: torch.stack([d[k] for d in mod.values()])
                for k in deltas}
        dev_up = set_devices(dev_params, idx,
                             {k: self.params[k][None] + repl[k]
                              for k in repl})
        return dev_up, set_devices(deltas, idx, repl)

    def _finalize_host(self, j: int, prep: RoundPrep, sched: S.Schedule,
                       st: UploadState, norms, dev_losses) -> Dict:
        """Host half of finalize: Eq. 12 G refresh from the device-side
        deviation norms (``norms``, [V] f32 — rows with no upload are
        garbage and never read), zero-upload degradation, and the round
        record.  The params update already happened in the fused
        finalize core."""
        cfg = self.cfg
        avail_idx = prep.avail_idx
        upload = st.upload
        g_errs = 0
        if upload.any():
            up = np.flatnonzero(upload)
            alphas = np.ones(len(up)) / len(up)
            try:
                g = E.g_hat(None, alphas, prep.p_sampled[up],
                            self.global_dist, norms=norms[up])
                if np.isfinite(g) and g > 0:
                    self.g_hat = g
                if self.single_class:
                    self.g_hat_c = E.g_hat_per_class(
                        None, alphas,
                        self.device_class[avail_idx][up],
                        prep.p_sampled[up], self.global_dist,
                        self.num_classes, norms=norms[up])
            except (ValueError, FloatingPointError, ZeroDivisionError):
                g_errs += 1
                self.g_refresh_errors += 1
        elif self.faults.enabled:
            # zero uploads landed: keep the previous params and decay the
            # estimates toward their priors instead of freezing them
            d = cfg.faults.estimate_decay
            self.sigma_hat = d * self.sigma_hat + (1 - d) * cfg.sigma_init
            self.g_hat = d * self.g_hat + (1 - d) * cfg.g_init
            self.g_hat_c = d * self.g_hat_c + (1 - d) * cfg.g_init

        num_attempted = sched.num_scheduled + st.num_bf_scheduled
        rec = {
            "round": j,
            "num_available": int(prep.avail.sum()),
            "num_scheduled": int(sched.num_scheduled),
            "wemd": float(sched.wemd),
            "sampling_variance": float(sched.sampling_variance),
            "objective": float(sched.objective),
            "sigma_hat": float(self.sigma_hat),
            "g_hat": float(self.g_hat),
            "mean_local_loss": float(dev_losses.mean()),
            # failure telemetry (the fault layer as observability layer)
            "num_uploaded": int(upload.sum()),
            "num_failed": int(num_attempted - upload.sum()),
            "failure_causes": st.cause_counts,
            "num_backfilled": int(st.num_backfilled),
            "num_sanitized": int(st.num_dropped_nf + st.num_clipped),
            "num_clipped": int(st.num_clipped),
            "num_infeasible": int((prep.bstar[avail_idx] < 0).sum()),
            # THIS round's Eq. 12 refresh failures; the trainer
            # attribute ``g_refresh_errors`` is the cumulative total.
            "g_refresh_errors_round": int(g_errs),
            # deprecated alias of g_refresh_errors_round (same value;
            # kept for readers of the old ambiguous key)
            "g_refresh_errors": int(g_errs),
        }
        if cfg.eval_every and (j % cfg.eval_every == 0):
            rec["test_accuracy"] = self.evaluate()
        self.history.append(rec)
        return rec

    def _finalize_round(self, j: int, prep: RoundPrep, sched: S.Schedule,
                        st: UploadState, dev_params, deltas,
                        dev_losses: np.ndarray) -> Dict:
        """Eq. 2 aggregation over the uploads that landed + the Eq. 12
        deviation norms in one fused call (cell axis of 1), then the host
        half (G refresh, degradation, round record)."""
        dev_up, deltas_eff = self._apply_mods(dev_params, deltas, st)
        w = torch.from_numpy(self._finalize_weights(st.upload)[None]) \
            .to(self.device)
        active = bool(st.upload.any())
        newp_c, norms_c = self._finalize_core(
            {k: x[None] for k, x in self.params.items()},
            {k: x[None] for k, x in dev_up.items()},
            {k: x[None] for k, x in deltas_eff.items()},
            w, [active])
        self.params = {k: x[0] for k, x in newp_c.items()}
        norms = None
        if active:       # the only device->host pull of finalize
            norms = norms_c[0].cpu().numpy()
            self.last_round_host_syncs += 1
        return self._finalize_host(j, prep, sched, st, norms, dev_losses)

    # ------------------------------------------------------------------
    def run_round(self, j: int) -> Dict:
        obs = self.obs
        with obs.span("round"):
            rec = self._run_round_phases(j)
        if obs.enabled:
            self._emit_round_obs(rec)
        return rec

    def _run_round_phases(self, j: int) -> Dict:
        """One round, each phase under an ``obs`` span (spans are the
        no-op singleton when observability is off)."""
        obs = self.obs
        with obs.span("prep"):
            prep = self._prepare_round(j)
        self.last_round_host_syncs = 0

        # fused round core: local update + sigma + deltas + norms +
        # NaN/Inf flags (cell axis of 1), one host pull for all of it
        with obs.span("core"):
            dev_params_c, losses_c, sigma_c, deltas_c, norms_c, fin_c = \
                self._round_core(
                    {k: x[None] for k, x in self.params.items()},
                    {k: x[None] for k, x in prep.batches.items()},
                    tuple(m[None] for m in prep.dropout))
            host = torch.stack([losses_c[0], sigma_c[0], norms_c[0],
                                fin_c[0].to(torch.float32)]).cpu().numpy()
            self.last_round_host_syncs += 1
            dev_losses, sigma_v, delta_norms = (
                np.asarray(x, dtype=np.float64) for x in host[:3])
            finite = host[3] > 0.5
            dev_params = {k: x[0] for k, x in dev_params_c.items()}
            deltas = {k: x[0] for k, x in deltas_c.items()}

        with obs.span("schedule"):
            self._post_core(prep, dev_losses, sigma_v)
            prob = self._make_problem(prep)
            sched = self._schedule(prob, prep.avail_idx, prep.gains,
                                   delta_norms, j)

        with obs.span("upload"):
            st = self._upload_phase(j, prep, sched, deltas, delta_norms,
                                    finite=finite)
            if self._wants_backfill(st, sched):
                prob_bf = self._backfill_problem(prob, sched, st, prep)
                if prob_bf is not None:
                    bf = self._schedule(prob_bf, prep.avail_idx,
                                        st.upload_gains, delta_norms, j)
                    self._apply_backfill(bf, st, prep, deltas,
                                         delta_norms, finite=finite)
        with obs.span("finalize"):
            rec = self._finalize_round(j, prep, sched, st, dev_params,
                                       deltas, dev_losses)
        self._obs_sched_iters = int(sched.iterations)
        return rec

    def _emit_round_obs(self, rec: Dict) -> None:
        """Mirror one round record into the metrics registry and the
        sinks (host-side only — runs after the round's device work, so
        it adds zero device->host syncs)."""
        m = self.obs.metrics
        m.counter("fl.rounds_total").inc()
        hs = self.last_round_host_syncs
        m.counter("fl.host_syncs_total").inc(hs)
        m.gauge("fl.round.host_syncs").set(hs)
        m.counter("fl.uploads_total").inc(rec["num_uploaded"])
        upload_bytes = rec["num_uploaded"] * self.payload / 8.0
        m.counter("fl.upload_bytes_total").inc(upload_bytes)
        m.gauge("fl.round.upload_bytes").set(upload_bytes)
        for cause, n in rec["failure_causes"].items():
            if n:
                m.counter(f"fl.failures.{cause}").inc(n)
        m.counter("fl.sanitized_total").inc(rec["num_sanitized"])
        m.counter("fl.clipped_total").inc(rec["num_clipped"])
        m.counter("fl.backfilled_total").inc(rec["num_backfilled"])
        m.counter("fl.g_refresh_errors_total").inc(
            rec["g_refresh_errors_round"])
        for g in ("sigma_hat", "g_hat", "wemd", "objective"):
            m.gauge(f"fl.{g}").set(rec[g])
        m.histogram("sched.iterations", COUNT_BUCKETS).observe(
            self._obs_sched_iters)
        self.obs.round_record(dict(
            rec, host_syncs=hs, upload_bytes=upload_bytes,
            sched_iterations=self._obs_sched_iters))

    # ------------------------------------------------------------------
    def evaluate(self, max_batches: int = 20, batch_size: int = 256) -> float:
        correct = total = 0
        for i in range(0, min(len(self.test), max_batches * batch_size),
                       batch_size):
            x = self.test.inputs[i:i + batch_size]
            y = self.test.labels[i:i + batch_size]
            pred = self._eval_batch(self.params, self.make_batch(x, y))
            correct += int((pred.cpu().numpy() == y).sum())
            total += len(y)
        return float(correct) / max(total, 1)

    def run(self, num_rounds: int, verbose: bool = False) -> List[Dict]:
        for j in range(num_rounds):
            rec = self.run_round(j)
            if verbose and ("test_accuracy" in rec):
                print(f"round {j:4d} sched={rec['num_scheduled']:3d} "
                      f"wemd={rec['wemd']:.3f} acc={rec['test_accuracy']:.3f}")
        return self.history


def _cnn_features_logits(params, cfg: CNNConfig, images):
    """Penultimate features + logits of the paper CNN (no dropout): the
    Eq. 10 sigma inputs."""
    feats = C.paper_cnn_features(params, cfg, images)
    return feats, feats @ params["fc2"] + params["b2"]
