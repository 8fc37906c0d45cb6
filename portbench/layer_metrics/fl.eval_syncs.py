"""Evaluation's device-to-host pulls an evaluation round (the round
record's ``eval_syncs``: one a test batch of each evaluated cell), mean
over the window's evaluation rounds (those with an ``eval`` span)."""


def read(run):
    recs = [r for r in run.layer.get("records") or []
            if "eval_syncs" in r
            and any(s[0] == "eval" for s in r.get("spans") or ())]
    if not recs:
        return None
    return sum(r["eval_syncs"] for r in recs) / len(recs)
