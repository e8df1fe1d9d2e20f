"""Device milliseconds between ``channel.round_exchange``'s entry and
exit events: the flat space's hist pipeline and its elementwise work
(mean over the window)."""
import statistics


def read(ctx):
    ms = ctx.get("spans", {}).get("exchange")
    return statistics.fmean(ms) if ms else None
