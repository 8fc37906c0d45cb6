"""Server-side delta sanitization (the defense half of the fault layer).

Before Eq. 2 aggregation every arrived upload is screened:
  * NaN/Inf guard (always on): a delta with any non-finite leaf is
    dropped — averaging it would poison the global model irreversibly.
  * Norm clip (``FaultConfig.clip_delta_norm`` > 0): a delta whose L2
    norm exceeds the clip is rescaled onto the clip ball and kept.

The sanitizer never mutates the stacked device parameters; it reports
which uploads survive and returns replacement deltas only for the ones
it modified, so a clean round leaves the aggregation inputs bitwise
untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.estimation import tree_leaves, tree_map, tree_norm


@dataclasses.dataclass
class SanitizeResult:
    kept: List[int]                 # upload indices entering aggregation
    dropped_nonfinite: List[int]    # uploads rejected by the NaN/Inf guard
    clipped: List[int]              # uploads rescaled onto the clip ball
    deltas: Dict[int, object]       # index -> replacement delta tree

    @property
    def num_sanitized(self) -> int:
        return len(self.dropped_nonfinite) + len(self.clipped)


def finite_per_device(stacked) -> np.ndarray:
    """[A] bool: device i's leaves are all finite (one vectorized pass)."""
    flags = [torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
             for x in tree_leaves(stacked)]
    out = flags[0]
    for f in flags[1:]:
        out = out & f
    return out.cpu().numpy()


def tree_is_finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def sanitize_updates(deltas, upload_idx: Sequence[int],
                     overrides: Dict[int, object], clip_norm: float,
                     norms: Optional[np.ndarray] = None,
                     finite: Optional[np.ndarray] = None) -> SanitizeResult:
    """Screen the uploads in ``upload_idx``.

    ``deltas`` is the stacked [A, ...] delta tree; ``overrides`` maps an
    index to a replacement (e.g. corrupted) delta that shadows the
    stacked row; ``norms`` optionally carries precomputed L2 norms for
    the unmodified rows.  ``finite`` optionally carries precomputed
    per-row NaN/Inf-guard flags (the fused round core emits them), in
    which case a clean round makes no device round-trip at all.
    """
    upload_idx = [int(i) for i in upload_idx]
    res = SanitizeResult(kept=[], dropped_nonfinite=[], clipped=[],
                         deltas=dict(overrides))
    if not upload_idx:
        return res
    plain = [i for i in upload_idx if i not in overrides]
    finite_map = {}
    if plain:
        fin = finite if finite is not None else finite_per_device(deltas)
        finite_map.update({i: bool(fin[i]) for i in plain})
    for i in upload_idx:
        delta = res.deltas.get(i)
        ok = tree_is_finite(delta) if delta is not None else finite_map[i]
        if not ok:
            res.dropped_nonfinite.append(i)
            res.deltas.pop(i, None)
            continue
        if clip_norm > 0:
            if delta is not None:
                norm = float(tree_norm(delta))
            elif norms is not None:
                norm = float(norms[i])
            else:
                norm = float(tree_norm(tree_map(lambda x: x[i], deltas)))
            if norm > clip_norm:
                if delta is None:
                    delta = tree_map(lambda x: x[i], deltas)
                scale = clip_norm / norm
                res.deltas[i] = tree_map(lambda x: x * scale, delta)
                res.clipped.append(i)
        res.kept.append(i)
    return res
