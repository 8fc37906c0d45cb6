"""The LM silo world, from the run's seed: silos hold token corpora of
different token-superclass mixes, and each round every silo offers
``per_silo_batch`` sequences drawn from its corpus.

Frozen copies of the port's ``data/datasets.synthetic_token_dataset``
(class c draws 70 % of its tokens from the c-th slice of the vocabulary)
and ``launch/federated_lm_silos.silo_world`` (silo s holds the sequences
of class s mod C; a sequence's histogram is over the C vocabulary
slices).

Parameters (the workload file's ``traffic``): ``silos``,
``per_silo_batch``, ``seq``, ``superclasses``, ``per_class``.
"""
from __future__ import annotations

import numpy as np


class SiloWorld:
    def __init__(self, vocab: int, p: dict, seed: int):
        from portbench.harness import subseed
        C, seq = p["superclasses"], p["seq"]
        rng = np.random.default_rng(subseed(seed, "corpus"))
        bucket = max(vocab // C, 1)
        xs, ys = [], []
        for c in range(C):
            lo = c * bucket
            for _ in range(p["per_class"]):
                base = rng.integers(0, vocab, size=seq + 1)
                biased = rng.integers(lo, min(lo + bucket, vocab),
                                      size=seq + 1)
                xs.append(np.where(rng.random(seq + 1) < 0.7, biased, base))
                ys.append(c)
        perm = rng.permutation(len(ys))
        self.tokens = np.stack(xs).astype(np.int32)[perm]    # [N, seq+1]
        labels = np.array(ys)[perm]
        self.silos = p["silos"]
        self.batch = p["per_silo_batch"]
        self.seq = seq
        self.classes = C
        self.bucket = bucket
        self.silo_idx = [np.flatnonzero(labels == (s % C))
                         for s in range(self.silos)]
        self.global_hist = self.histogram(self.tokens)
        self.rng = np.random.default_rng(subseed(seed, "rounds"))

    def histogram(self, tokens):
        h = np.bincount(np.minimum(tokens.reshape(-1) // self.bucket,
                                   self.classes - 1),
                        minlength=self.classes)
        return h / h.sum()

    def next_round(self):
        """(token rows [silos * batch, seq + 1], each silo's histogram
        [silos, C]) of the next round."""
        takes = [self.rng.choice(self.silo_idx[s], size=self.batch)
                 for s in range(self.silos)]
        hist = np.stack([self.histogram(self.tokens[t]) for t in takes])
        return self.tokens[np.concatenate(takes)], hist
