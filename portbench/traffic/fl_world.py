"""The FL world of the ResNet18-GN cells, from the run's seed.

CIFAR-shaped synthetic images: each class a smoothed random template,
each image its class's template rolled by a shift in [-3, 3] on both
axes plus N(0, noise) pixel noise (the port's
``data/datasets.synthetic_image_dataset``, frozen here and drawn on the
device in a few large calls, then handed to the trainer as host arrays,
as the trainer samples its batches on the host).  The training images
are split over the devices by ``dirichlet_partition`` (a frozen copy of
the port's ``data/partition.dirichlet_partition``).

Parameters (the workload file's ``traffic``): ``classes``,
``train_per_class``, ``test_per_class``, ``image_size``, ``channels``,
``noise``, ``num_devices``, ``alpha``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

CHUNK = 8192


@dataclasses.dataclass
class World:
    train_x: np.ndarray        # [N, H, W, C] f32
    train_y: np.ndarray        # [N] int32
    test_x: np.ndarray
    test_y: np.ndarray
    parts: List[np.ndarray]    # each device's training indices
    classes: int


def images(classes, per_class, size, channels, noise, gen, device):
    """(images [N, H, W, C] f32, labels [N] int32) on the host, N =
    classes * per_class in a random order; ``gen`` a generator on
    ``device``."""
    t = torch.randn((classes, size, size, channels), generator=gen,
                    device=device)
    t = (t + torch.roll(t, 1, 1) + torch.roll(t, 1, 2)) / 3.0
    n = classes * per_class
    labels = torch.arange(classes, device=device).repeat_interleave(
        per_class)[torch.randperm(n, generator=gen, device=device)]
    shift = torch.randint(-3, 4, (n, 2), generator=gen, device=device)
    ar = torch.arange(size, device=device)
    out = np.empty((n, size, size, channels), np.float32)
    for a in range(0, n, CHUNK):
        b = min(n, a + CHUNK)
        rows = (ar[None, :] - shift[a:b, 0:1]) % size            # [m, H]
        cols = (ar[None, :] - shift[a:b, 1:2]) % size            # [m, W]
        img = t[labels[a:b, None, None], rows[:, :, None], cols[:, None, :]]
        img = img + noise * torch.randn(img.shape, generator=gen,
                                        device=device)
        out[a:b] = img.cpu().numpy()
    return out, labels.to(torch.int32).cpu().numpy()


def dirichlet_partition(labels: np.ndarray, num_devices: int, alpha: float,
                        rng: np.random.Generator,
                        samples_per_device: int = 0) -> List[np.ndarray]:
    """Device label distribution ~ Dir(alpha * p); equal device sizes."""
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
            take.extend(pool.pop() for _ in range(min(n, len(pool))))
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


def make(p: dict, seed: int, device) -> World:
    from portbench.harness import subseed
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "images"))
    kw = dict(classes=p["classes"], size=p["image_size"],
              channels=p["channels"], noise=p["noise"], gen=gen,
              device=device)
    train_x, train_y = images(per_class=p["train_per_class"], **kw)
    test_x, test_y = images(per_class=p["test_per_class"], **kw)
    rng = np.random.default_rng(subseed(seed, "partition"))
    parts = dirichlet_partition(train_y, p["num_devices"], p["alpha"], rng)
    return World(train_x, train_y, test_x, test_y, parts, p["classes"])
