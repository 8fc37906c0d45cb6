"""Evaluation, host ms an evaluation round: the round's ``eval`` spans
(the trainers' span around ``evaluate``, nested in ``finalize``; an
eight-cell round holds eight) summed, mean over the window's evaluation
rounds."""


def read(run):
    per_round = []
    for r in run.layer.get("records") or []:
        spans = [s for s in r.get("spans") or () if s[0] == "eval"]
        if spans:
            per_round.append(sum(s[3] - s[2] for s in spans))
    if not per_round:
        return None
    return 1e-6 * sum(per_round) / len(per_round)
