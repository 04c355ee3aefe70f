"""mfu.prefill: the forward model FLOPs (``work/<family>.py``) a second of
the window's requests before the traced stretch (all of them in an
untraced run), over the H100's 989 TFLOP/s of dense bf16, in %."""
from portbench.readings import forward_flops, share_of_peak, untraced


def read(ctx, run):
    if ctx.device.type != "cuda" or not run["record"].get("requests"):
        return None
    units, wall = untraced(run)
    if not units:
        return None
    return share_of_peak(sum(forward_flops(ctx, 1, u["tokens"])
                             for u in units), wall)
