"""Device milliseconds from a round's start event to the event at
``model.loss_fn``'s return: the forward pass (mean over the window)."""
import statistics


def read(ctx):
    ms = ctx.get("spans", {}).get("forward")
    return statistics.fmean(ms) if ms else None
