"""peak_mem_gib: torch.cuda.max_memory_allocated() over the port's set-up
and the measured window, read before the plain reference runs, in GiB. It
sets how many scans a card holds, and shows work moved into caches."""


def read(ctx):
    return ctx.peak_bytes / 2**30
