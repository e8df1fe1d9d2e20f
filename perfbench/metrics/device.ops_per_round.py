"""Device operations (kernels, copies, sets) a round in the profiled
stretch."""


def read(ctx):
    t = ctx.get("trace", {})
    return t["ops"] / t["rounds"] if t.get("rounds") else None
