"""The numbers that decide ``correct``, from a program's record and the
reference's of the same steps.

Norms are compared leaf by leaf: the gap between the program's norm of a
leaf and the reference's, over the larger of the reference's norm of
that leaf and of the median leaf, the worst leaf reported.  Leaves whose
first reference gradient is under a thousandth of the median leaf's are
left out: they move by round-off alone.
"""
from __future__ import annotations

import numpy as np
import torch

DEAD = 1e-3


def leaf_norms(a: dict, b: dict) -> dict:
    """{leaf: ||a - b||} in f64."""
    return {k: float(torch.linalg.vector_norm(
        a[k].double() - b[k].double())) for k in a}


def kept(first_ref: dict):
    """The leaves that count: first reference gradient at least a
    thousandth of the median leaf's."""
    med = float(np.median(list(first_ref.values())))
    return [k for k, v in first_ref.items() if v >= DEAD * med]


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    if not keys:
        return 0.0
    r = np.array([ref[k] for k in keys])
    p = np.array([prog[k] for k in keys])
    med = float(np.median(r))
    if med == 0.0:
        return 0.0 if not p.any() else float("inf")
    return float(np.max(np.abs(p - r) / np.maximum(r, med)))


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """{leaf: gap} as ``leaf_gap`` measures each."""
    med = float(np.median([ref[k] for k in keys])) if keys else 0.0
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def median(gaps: dict) -> float:
    return float(np.median(list(gaps.values()))) if gaps else 0.0


def rel(p, r) -> float:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    if p.shape != r.shape:
        return float("inf")
    if p.size == 0:
        return 0.0
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-30)))


def fl_numbers(prog, ref, params0) -> dict:
    """The FL round's numbers over the recorded rounds of one cell:
    ``schedule`` (devices whose availability or schedule differs, exact),
    ``sigma`` (Eq. 10, worst relative gap), ``loss`` (each device's local
    loss, worst relative gap), the same two in the first round alone
    (``sigma0``, ``loss0``: forward passes at the shared first model),
    ``grad`` (the first round's update, worst leaf), ``change`` (the
    model's change over all the rounds, worst leaf), the median leaf's gap
    of both (``grad_median``, ``change_median``), and ``worst``, the first
    update's three worst leaves by name."""
    sched, sig, loss = 0, 0.0, 0.0
    for p, r in zip(prog, ref):
        a_p, a_r = set(p["avail"].tolist()), set(r["avail"].tolist())
        if a_p != a_r:
            sched += len(a_p ^ a_r)
            sig = loss = float("inf")
            continue
        s_p = set(p["avail"][p["mask"]].tolist())
        s_r = set(r["avail"][r["mask"]].tolist())
        sched += len(s_p ^ s_r)
        sig = max(sig, rel(p["sigma"], r["sigma"]))
        loss = max(loss, rel(p["losses"], r["losses"]))
    g_ref = leaf_norms(ref[0]["params"], params0)
    keys = kept(g_ref)
    g_prog = leaf_norms(prog[0]["params"], params0)
    c_prog = leaf_norms(prog[-1]["params"], params0)
    c_ref = leaf_norms(ref[-1]["params"], params0)
    grads = leaf_gaps(g_prog, g_ref, keys)
    first = prog[0]["avail"].tolist() == ref[0]["avail"].tolist()
    return {"schedule": float(sched), "sigma": sig, "loss": loss,
            "sigma0": rel(prog[0]["sigma"], ref[0]["sigma"]) if first
            else float("inf"),
            "loss0": rel(prog[0]["losses"], ref[0]["losses"]) if first
            else float("inf"),
            "grad": leaf_gap(g_prog, g_ref, keys),
            "change": leaf_gap(c_prog, c_ref, keys),
            "grad_median": median(grads),
            "change_median": median(leaf_gaps(c_prog, c_ref, keys)),
            "worst": sorted(grads.items(), key=lambda kv: -kv[1])[:3]}
