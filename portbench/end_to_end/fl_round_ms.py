"""Wall time of the window over the FL rounds it completed, evaluation
rounds included."""


def read(run):
    return 1e3 * run.window_s / len(run.steps)
