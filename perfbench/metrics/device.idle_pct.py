"""The share of the profiled stretch (the first round's start on the host
to the last device operation's end) that no device operation covers:
the union of the CUPTI intervals."""


def read(ctx):
    t = ctx.get("trace", {})
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
