"""Seconds from the process's start to the window's first round: the
build (the first run in a checkout), the weights and feed, the first
rounds and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
