"""The silo round's schedule (the program's ``core.fscd`` on the host),
the benchmark's own span around the call, ms, mean over the window."""


def read(run):
    s = run.layer.get("schedule_s") or []
    return 1e3 * sum(s) / len(s) if s else None
