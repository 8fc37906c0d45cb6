"""Device-to-host pulls a round (the trainer's ``last_round_host_syncs``,
as its obs records carry it), mean over the window's rounds."""


def read(run):
    recs = run.layer.get("records") or []
    if not recs:
        return None
    return sum(r["host_syncs"] for r in recs) / len(recs)
