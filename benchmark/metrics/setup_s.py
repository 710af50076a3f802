"""Seconds from process start to the first timed unit of work: imports,
inputs, weights, kernel builds and the warm-up batch."""


def read(run):
    return run.setup_s
