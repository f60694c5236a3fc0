"""Seconds from process start to the first timed call: generating the
inputs, building and loading the kernels, and one warm-up simulation of
every pool entry."""


def read(w):
    return w.setup_s
