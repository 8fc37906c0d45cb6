"""FedCGD's round (Algorithm 3 of the paper) in plain NumPy and PyTorch:
the reference the FL cells are held to.

A round: devices are available with probability p_a; the TR 38.901
UMi channel gives each its Eq. 9 minimum bandwidth; every available
device takes tau SGD steps (Eq. 1) from the server's model on batches
sampled from its data and reports sigma_v (Eq. 10, the classifier
head's per-sample gradients on its first batch, materialised here in
f64); the server solves P1 by FSCD (Algorithm 2) over the sampled label
histograms, sigma-hat (Eq. 11) and G-hat, averages the scheduled
devices' models (Eq. 2) and refreshes G-hat (Eq. 12).

The host draws follow the trainer's stream order (the cell's positions,
then each round: availability, the channel's LOS and shadowing draws,
each available device's batch), so one generator seeded as the
trainer's replays its rounds.  The channel, Eq. 9 and the WEMD solvers
are frozen copies of the port's numpy code, which the port's torch
scheduler is held to bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import lambertw

from portbench.reference import resnet18gn as R

# paper Table I (TR 38.901 UMi street canyon)
CELL_RADIUS_M = 250.0
CARRIER_GHZ = 3.5
TOTAL_BW_HZ = 20e6
TX_POWER_W = 10 ** (23.0 / 10.0) * 1e-3
DEVICE_H, BS_H = 1.5, 10.0
NOISE_PSD_W = 10 ** ((-174.0 + 6.0) / 10.0) * 1e-3
SHADOW_LOS_DB, SHADOW_NLOS_DB = 4.0, 8.2


# ---------------------------------------------------------------------------
# channel and Eq. 9


class Cell:
    def __init__(self, num_devices, rng):
        r = CELL_RADIUS_M * np.sqrt(rng.random(num_devices))
        theta = rng.random(num_devices) * 2 * np.pi
        pos = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
        d2d = np.linalg.norm(pos, axis=1)
        d3d = np.sqrt(d2d ** 2 + (BS_H - DEVICE_H) ** 2)
        d2 = np.maximum(d2d, 1e-3)
        p = 18.0 / d2 + np.exp(-d2 / 36.0) * (1.0 - 18.0 / d2)
        self.p_los = np.where(d2 <= 18.0, 1.0, np.minimum(p, 1.0))
        d3 = np.maximum(d3d, 1.0)
        self.pl_los = 32.4 + 21.0 * np.log10(d3) + 20.0 * np.log10(CARRIER_GHZ)
        self.pl_nlos = 32.4 + 31.9 * np.log10(d3) + 20.0 * np.log10(
            CARRIER_GHZ)

    def gains(self, rng):
        los = rng.random(len(self.p_los)) < self.p_los
        pl = np.where(los, self.pl_los, self.pl_nlos)
        shadow = rng.normal(0.0, np.where(los, SHADOW_LOS_DB,
                                          SHADOW_NLOS_DB))
        return 10 ** (-(pl + shadow) / 10.0)


def min_bandwidth(bits, deadline_s, rx_power):
    """Eq. 9 through Lambert W's -1 branch; -1 where infeasible."""
    gamma = NOISE_PSD_W * bits * np.log(2.0) / (deadline_s * rx_power)
    ok = gamma < 1.0
    g = np.where(ok, gamma, 0.5)
    w = lambertw(-g * np.exp(-g), k=-1).real
    return np.where(ok, -bits * np.log(2.0) / (deadline_s * (w + g)), -1.0)


# ---------------------------------------------------------------------------
# WEMD and FSCD (Algorithm 2)


def _class_sum(x, w):
    acc = x[..., 0] * w[0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * w[c]
    return acc


def wemd_of_set(p_dev, mask, gd, cw):
    m = np.asarray(mask, np.float64)
    if m.sum() == 0:
        return float(gd @ cw)
    return float(np.abs(m @ p_dev / m.sum() - gd) @ cw)


def fscd(p_dev, gd, cw, sigma, batch, min_bw, total_bw, max_inner=200):
    """The schedule mask [V] of Algorithm 2."""
    V = p_dev.shape[0]
    feas = (min_bw >= 0) & (min_bw <= total_bw)
    bw = np.where(feas, min_bw, np.inf)
    order = np.argsort(bw, kind="stable")
    sigma_b = sigma / np.sqrt(batch)
    best_mask, best_obj = np.zeros(V, bool), np.inf
    S_max = int((np.cumsum(bw[order]) <= total_bw + 1e-9).sum())
    for S in range(S_max, 0, -1):
        mask = np.zeros(V, bool)
        mask[order[:S]] = True
        p_sum = p_dev[mask].sum(axis=0)
        used = float(bw[order[:S]].sum())
        w_cur = wemd_of_set(p_dev, mask, gd, cw)
        for _ in range(max_inner):
            in_idx = np.flatnonzero(mask)
            out_idx = np.flatnonzero(~mask & feas)
            if len(out_idx) == 0:
                break
            base = (p_sum[None, None, :] - p_dev[in_idx][:, None, :]
                    + p_dev[out_idx][None, :, :])
            w_swap = _class_sum(np.abs(base / S - gd[None, None, :]), cw)
            bw_new = used - bw[in_idx][:, None] + bw[out_idx][None, :]
            w_swap = np.where(bw_new <= total_bw + 1e-9, w_swap, np.inf)
            i, j = np.unravel_index(np.argmin(w_swap), w_swap.shape)
            if w_swap[i, j] >= w_cur - 1e-12:
                break
            vi, vj = in_idx[i], out_idx[j]
            mask[vi], mask[vj] = False, True
            p_sum += p_dev[vj] - p_dev[vi]
            used = float(bw_new[i, j])
            w_cur = float(w_swap[i, j])
        obj = w_cur + sigma_b / np.sqrt(S)
        if obj < best_obj:
            best_obj, best_mask = obj, mask.copy()
        if S > 1 and w_cur + sigma_b / np.sqrt(S) <= sigma_b / np.sqrt(S - 1):
            break
    return best_mask


# ---------------------------------------------------------------------------
# Eq. 10


def sigma_eq10(feats, logits, labels):
    """sqrt(mean_i ||g_i - mean g||^2) over the head's per-sample
    gradients g_i = h_i (softmax_i - onehot_i)^T, materialised in f64."""
    h = feats.to(torch.float64)
    e = torch.softmax(logits.to(torch.float64), -1) - F.one_hot(
        labels.long(), logits.shape[-1]).to(torch.float64)
    g = h[:, :, None] * e[:, None, :]
    dev = g - g.mean(0, keepdim=True)
    return float(torch.sqrt((dev * dev).sum((1, 2)).mean()))


# ---------------------------------------------------------------------------
# the round


def replay(world, fl: dict, params0: dict, rounds: int, device, rnd=None,
           fault=None):
    """``rounds`` FedCGD rounds from ``params0`` on ``world``.  ``fl``:
    num_devices, available_prob, batch_size, tau, eta, deadline_s,
    sigma_init, g_init, seed (the trainer's), payload_bits.  ``rnd``
    rounds the operands of every product (the control); ``fault`` plants
    one of the faults a check must catch ("half": each local step over
    half its batch; "answer": the first available device's schedule bit
    flipped).  Returns one record a round: ``avail`` (device ids),
    ``losses``, ``sigma``, ``mask`` (over the available devices) and
    ``params`` after the round."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    V, b, tau, eta = (fl["num_devices"], fl["batch_size"], fl["tau"],
                      fl["eta"])
    rng = np.random.default_rng(fl["seed"])
    cell = Cell(V, rng)
    labels = world.train_y
    C = world.classes
    all_idx = np.concatenate(world.parts)
    gd = np.bincount(labels[all_idx], minlength=C) / len(all_idx)
    params = {k: v.detach().to(torch.float32).clone()
              for k, v in params0.items()}
    bits = fl["payload_bits"] or 32 * sum(v.numel() for v in params.values())
    sigma_hat, g_hat = fl["sigma_init"], fl["g_init"]
    out = []
    for _ in range(rounds):
        avail = rng.random(V) < fl["available_prob"]
        if not avail.any():
            avail[rng.integers(V)] = True
        avail_idx = np.flatnonzero(avail)
        bstar = min_bandwidth(bits, fl["deadline_s"],
                              TX_POWER_W * cell.gains(rng))
        xs, ys, hists = [], [], []
        for v in avail_idx:
            idx = world.parts[v]
            take = rng.choice(idx, size=tau * b, replace=len(idx) < tau * b)
            xs.append(world.train_x[take].reshape((tau, b) +
                                                  world.train_x.shape[1:]))
            ys.append(labels[take].reshape(tau, b))
            hists.append(np.bincount(labels[take], minlength=C) / len(take))
        p_s = np.stack(hists)
        losses, sigmas, dev_params = [], [], []
        for x, y in zip(xs, ys):
            x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            y = torch.from_numpy(y.astype(np.int64)).to(device)
            with torch.no_grad():
                f0 = R.features(params, x[0], rnd=rnd)
                sigmas.append(sigma_eq10(f0, R.head(params, f0, rnd), y[0]))
            p, ls = params, []
            for t in range(tau):
                xt, yt = (x[t], y[t]) if fault != "half" else (
                    x[t][:b // 2], y[t][:b // 2])
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in p.items()}
                loss = F.cross_entropy(R.head(leaves, R.features(
                    leaves, xt, rnd=rnd), rnd), yt)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                p = {k: v.detach() - eta * g
                     for (k, v), g in zip(leaves.items(), grads)}
                ls.append(float(loss.detach()))
            losses.append(float(np.mean(ls)))
            dev_params.append(p)
        sigma_v = np.array(sigmas)
        sigma_hat = float(np.sqrt(np.mean(sigma_v ** 2)))
        mask = fscd(p_s, gd, np.full(C, g_hat), sigma_hat, b,
                    bstar[avail_idx], TOTAL_BW_HZ)
        if fault == "answer":
            mask[0] = not mask[0]
        finite = np.array([all(bool(torch.isfinite(d[k] - params[k]).all())
                               for k in params) for d in dev_params])
        up = np.flatnonzero(mask & finite)
        if len(up):
            new = {k: torch.stack([dev_params[i][k] for i in up]).mean(0)
                   for k in params}
            deltas = [{k: dev_params[i][k] - params[k] for k in params}
                      for i in up]
            mean_d = {k: torch.stack([d[k] for d in deltas]).mean(0)
                      for k in params}
            norms = np.array([float(torch.sqrt(sum(
                ((d[k] - mean_d[k]).double() ** 2).sum() for k in params)))
                for d in deltas]) / (tau * eta)
            l1 = np.abs(p_s[up] - gd).sum(axis=1)
            valid = l1 >= 1e-9
            if valid.any():
                g = float(np.max(norms[valid] / l1[valid]))
                if np.isfinite(g) and g > 0:
                    g_hat = g
            params = new
        out.append({"avail": avail_idx, "losses": np.array(losses),
                    "sigma": sigma_v, "mask": mask, "params": params})
    return out


def tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits, to nearest even), as
    a TF32 product rounds its operands; the gradient passes through."""
    i = x.detach().to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32) - x).detach()
