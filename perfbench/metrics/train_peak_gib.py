"""``torch.cuda.max_memory_allocated`` over the window (reset at its
start, so the training state counts), in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30
