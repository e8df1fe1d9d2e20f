"""The 90th percentile of every round of the window: a round is the
device-timeline interval between CUDA events recorded at consecutive
round starts on the stream (the last one closed by an event after it).
A window of fewer than ten rounds has no tail beyond its 90th percentile:
it reads its slowest round."""
import statistics


def read(ctx):
    ms = ctx["round_ms"]
    return statistics.quantiles(ms, n=10, method="inclusive")[8] if len(ms) >= 10 else max(ms)
