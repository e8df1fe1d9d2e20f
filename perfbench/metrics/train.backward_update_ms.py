"""Device milliseconds from ``model.loss_fn``'s return to the entry of
``channel.round_exchange``: the backward pass, the optimizer and ΔW
(mean over the window)."""
import statistics


def read(ctx):
    ms = ctx.get("spans", {}).get("backward_update")
    return statistics.fmean(ms) if ms else None
