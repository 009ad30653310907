"""torch.cuda.max_memory_allocated() from process start to the window's
end, GiB (the reference runs later and is not in it)."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
