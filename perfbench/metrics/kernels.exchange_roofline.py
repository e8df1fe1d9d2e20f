"""The exchange's least time (16 bytes an entry over 3.35 TB/s) over the
CUPTI device time, a round, of every device operation launched inside
the ``round_exchange`` range of the profiled stretch."""
import pb_flops


def read(ctx):
    t = ctx.get("trace", {})
    if not t.get("range_s"):
        return None
    return 100.0 * pb_flops.exchange_bound_s(ctx["entries"]) / (t["range_s"] / t["rounds"])
