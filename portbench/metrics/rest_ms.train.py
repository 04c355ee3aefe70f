"""rest_ms.train: device ms a step outside the matrix products, the named
kernels (flash attention, the SSD, the WKV) and AdamW, over the traced
steps: the unfused elementwise work, norms, casts, the loss, copies."""
from portbench.readings import on_device, outside_ms, units


def read(ctx, run):
    if not on_device(ctx, run):
        return None
    return outside_ms(run, ("gemm", "flash", "ssd", "wkv")) / units(run)
