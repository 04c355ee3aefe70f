"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated`` over the run's
set-up and window, in GiB."""


def read(ctx, run):
    if ctx.device.type != "cuda":
        return None
    return run["record"]["peak_bytes"] / 2 ** 30
