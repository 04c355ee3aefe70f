"""mfu.train: the model's FLOPs a second (three times the forward's,
``work/<family>.py``: every weight product at every application,
attention's causal pairs, the scans' least products) over the H100's 989
TFLOP/s of dense bf16, in %; over the window's steps before the traced
stretch (all of them in an untraced run)."""
from portbench.readings import forward_flops, share_of_peak, untraced


def read(ctx, run):
    if ctx.device.type != "cuda" or not run["record"].get("steps"):
        return None
    mix = ctx.cell.traffic
    units, wall = untraced(run)
    if not units:
        return None
    per_step = 3 * forward_flops(ctx, mix["batch"], mix["seq_len"])
    return share_of_peak(per_step * len(units), wall)
