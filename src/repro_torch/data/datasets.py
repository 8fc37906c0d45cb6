"""Offline-safe datasets.

No network access in this container, so CIFAR-10/100 are replaced by
*synthetic class-structured image datasets*: each class has a random but
fixed spatial template; samples are template + per-sample noise + random
shifts.  A linear probe cannot solve it at high noise, a small CNN can —
exactly the regime the paper's scheduling effects need (label
distributions drive gradients).  Token datasets for the LM architectures
are class-structured Markov streams so that "label histograms" (token
superclass histograms, DESIGN.md §4) are meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    inputs: np.ndarray     # images [N,H,W,C] f32  or tokens [N,S] i32
    labels: np.ndarray     # [N] int
    num_classes: int

    def __len__(self):
        return len(self.labels)


def synthetic_image_dataset(num_classes: int = 10, num_per_class: int = 500,
                            image_size: int = 32, channels: int = 3,
                            noise: float = 0.6, seed: int = 0,
                            ) -> ArrayDataset:
    """CIFAR-like synthetic classification data."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0, 1, (num_classes, image_size, image_size,
                                  channels)).astype(np.float32)
    # smooth the templates a little so shifts matter
    templates = (templates + np.roll(templates, 1, 1)
                 + np.roll(templates, 1, 2)) / 3.0
    xs, ys = [], []
    for c in range(num_classes):
        shift = rng.integers(-3, 4, size=(num_per_class, 2))
        for s in range(num_per_class):
            img = np.roll(templates[c], tuple(shift[s]), axis=(0, 1))
            xs.append(img + rng.normal(0, noise, img.shape))
            ys.append(c)
    xs = np.stack(xs).astype(np.float32)
    ys = np.array(ys, dtype=np.int32)
    perm = rng.permutation(len(ys))
    return ArrayDataset(xs[perm], ys[perm], num_classes)


def synthetic_token_dataset(vocab_size: int, seq_len: int,
                            num_classes: int = 16, num_per_class: int = 64,
                            seed: int = 0) -> ArrayDataset:
    """Class-structured token streams: class c biases a distinct slice of
    the vocabulary (so token-superclass histograms separate classes)."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    bucket = max(vocab_size // num_classes, 1)
    for c in range(num_classes):
        lo = c * bucket
        for _ in range(num_per_class):
            base = rng.integers(0, vocab_size, size=seq_len)
            biased = rng.integers(lo, min(lo + bucket, vocab_size),
                                  size=seq_len)
            pick = rng.random(seq_len) < 0.7
            xs.append(np.where(pick, biased, base))
            ys.append(c)
    xs = np.stack(xs).astype(np.int32)
    ys = np.array(ys, dtype=np.int32)
    perm = rng.permutation(len(ys))
    return ArrayDataset(xs[perm], ys[perm], num_classes)


def train_test_split(ds: ArrayDataset, test_frac: float = 0.2,
                     seed: int = 0) -> Tuple[ArrayDataset, ArrayDataset]:
    rng = np.random.default_rng(seed)
    n = len(ds)
    perm = rng.permutation(n)
    nt = int(n * test_frac)
    te, tr = perm[:nt], perm[nt:]
    return (ArrayDataset(ds.inputs[tr], ds.labels[tr], ds.num_classes),
            ArrayDataset(ds.inputs[te], ds.labels[te], ds.num_classes))


def batch_iterator(ds: ArrayDataset, indices: np.ndarray, batch_size: int,
                   rng: np.random.Generator):
    """Endless shuffled batches over a device's index set."""
    idx = np.array(indices)
    while True:
        rng.shuffle(idx)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            take = idx[i:i + batch_size]
            yield ds.inputs[take], ds.labels[take]


def sample_batch(ds: ArrayDataset, indices: np.ndarray, batch_size: int,
                 rng: np.random.Generator):
    take = rng.choice(indices, size=min(batch_size, len(indices)),
                      replace=len(indices) < batch_size)
    return ds.inputs[take], ds.labels[take]
