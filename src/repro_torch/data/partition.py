"""Non-IID client partitioners (paper Section VI-A).

(1) sort_and_partition(l, r): sort by label, split into shards, give each
    device l shards; smaller l = more heterogeneity.  The *total* dataset
    may itself be imbalanced: the second half of the classes is
    oversampled by the imbalance ratio r = n2/n1 (r in {1,3,9} in Fig. 5).
(2) dirichlet(alpha): each device's label distribution ~ Dir(alpha * p).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def apply_imbalance(labels: np.ndarray, ratio: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Subsample indices so second-half classes outnumber first-half ones
    by `ratio` (returns indices into the dataset)."""
    classes = np.unique(labels)
    half = len(classes) // 2
    idx = []
    for c in classes:
        ci = np.flatnonzero(labels == c)
        rng.shuffle(ci)
        if ratio >= 1:
            keep = len(ci) if c >= classes[half] else int(len(ci) / ratio)
        else:
            keep = len(ci) if c < classes[half] else int(len(ci) * ratio)
        idx.append(ci[:keep])
    out = np.concatenate(idx)
    rng.shuffle(out)
    return out


def sort_and_partition(labels: np.ndarray, num_devices: int,
                       shards_per_device: int,
                       rng: np.random.Generator) -> List[np.ndarray]:
    """Each device receives `shards_per_device` contiguous label-sorted
    shards. Returns per-device index arrays."""
    order = np.argsort(labels, kind="stable")
    num_shards = num_devices * shards_per_device
    shards = np.array_split(order, num_shards)
    shard_ids = rng.permutation(num_shards)
    out = []
    for v in range(num_devices):
        ids = shard_ids[v * shards_per_device:(v + 1) * shards_per_device]
        out.append(np.concatenate([shards[i] for i in ids]))
    return out


def dirichlet_partition(labels: np.ndarray, num_devices: int, alpha: float,
                        rng: np.random.Generator,
                        samples_per_device: int = 0) -> List[np.ndarray]:
    """Device label distribution ~ Dir(alpha * p); equal device sizes
    (paper: each device holds the same number of samples)."""
    classes = np.unique(labels)
    p_global = np.array([(labels == c).mean() for c in classes])
    if samples_per_device == 0:
        samples_per_device = len(labels) // num_devices
    pools = {c: list(rng.permutation(np.flatnonzero(labels == c)))
             for c in classes}
    out = []
    for _ in range(num_devices):
        pv = rng.dirichlet(alpha * p_global * len(classes))
        counts = rng.multinomial(samples_per_device, pv)
        take = []
        for c, n in zip(classes, counts):
            pool = pools[c]
            got = [pool.pop() for _ in range(min(n, len(pool)))]
            take.extend(got)
        # top up from whatever is left if some pools ran dry
        short = samples_per_device - len(take)
        if short > 0:
            rest = [i for pool in pools.values() for i in pool]
            rng.shuffle(rest)
            grabbed = rest[:short]
            take.extend(grabbed)
            grabbed_set = set(grabbed)
            for c in classes:
                pools[c] = [i for i in pools[c] if i not in grabbed_set]
        out.append(np.array(take, dtype=np.int64))
    return out


def label_distributions(labels: np.ndarray, device_indices: List[np.ndarray],
                        num_classes: int) -> np.ndarray:
    """[V, C] empirical label distribution of each device."""
    out = np.zeros((len(device_indices), num_classes))
    for v, idx in enumerate(device_indices):
        if len(idx):
            out[v] = np.bincount(labels[idx], minlength=num_classes) / len(idx)
    return out


def global_distribution(labels: np.ndarray, device_indices: List[np.ndarray],
                        num_classes: int) -> np.ndarray:
    """Label distribution of the union of participating devices' data."""
    all_idx = np.concatenate([i for i in device_indices if len(i)])
    return np.bincount(labels[all_idx], minlength=num_classes) / len(all_idx)
