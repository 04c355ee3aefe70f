"""rest_ms_per_ktok.prefill: device ms outside the matrix products and the
named kernels (flash attention, the SSD, the WKV) per 1,000 prompt tokens,
over the traced requests."""
from portbench.readings import on_device, outside_ms, stretch_tokens


def read(ctx, run):
    if not on_device(ctx, run):
        return None
    return outside_ms(run, ("gemm", "flash", "ssd", "wkv")) \
        * 1e3 / stretch_tokens(run)
