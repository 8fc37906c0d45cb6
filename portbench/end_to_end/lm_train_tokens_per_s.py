"""Tokens of the silo rounds the window completed over the window's time
up to the end of the last of them."""


def read(run):
    return sum(work for _, _, work in run.steps) / run.window_s
