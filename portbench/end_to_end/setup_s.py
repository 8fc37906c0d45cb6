"""Set-up: from the start of the process to the first timed step, the
world, the weights, the build, the recorded first steps and the warm-up
included."""


def read(run):
    return run.setup_s
