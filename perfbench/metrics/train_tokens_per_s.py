"""Token positions the window's rounds trained, over its wall time (the
host's clock, from the first round's issue to the synchronise that
closes the window)."""


def read(ctx):
    return ctx["rounds"] * ctx["tokens_per_round"] / ctx["window_s"]
