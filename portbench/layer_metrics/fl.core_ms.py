"""The round's ``core`` phase (the trainer's obs span), host ms, mean over
the window's rounds."""


def read(run):
    recs = [r for r in run.layer.get("records") or []
            if "core" in r.get("phases", {})]
    if not recs:
        return None
    return 1e3 * sum(r["phases"]["core"] for r in recs) / len(recs)
