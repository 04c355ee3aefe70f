"""ssd_roofline.train: the least time of a training step's SSD work (one
forward and one backward a layer at the step's batch and length,
``work/ssd.py``; the remat replay is not work) over the device time of
every SSD-kernel launch a step (``groups/ssd.json``), in %."""
from portbench.readings import on_device, units
from portbench.work.ssd import ssd_bound, ssd_bwd_bound
from portbench.work.zamba2 import ssm_dims


def read(ctx, run):
    if not on_device(ctx, run):
        return None
    kernel_s = run["summary"]["group_s"]["ssd"] / units(run)
    if kernel_s <= 0:
        return None
    m, mix = ctx.model, ctx.cell.traffic
    H, P, N, _ = ssm_dims(m)
    B, S = mix["batch"], mix["seq_len"]
    least_ms = m["n_layers"] * (ssd_bound(B, S, H, P, N, "bfloat16")[0]
                                + ssd_bwd_bound(B, S, H, P, N, "bfloat16")[0])
    return 100.0 * least_ms / 1e3 / kernel_s
