"""wkv_roofline.train: the least time of a training step's WKV work (one
forward and one backward a layer at the step's batch and length,
``work/wkv.py``; the remat replay is not work) over the device time of
every WKV-kernel launch a step (``groups/wkv.json``), in %."""
from portbench.readings import on_device, units
from portbench.work.wkv import wkv_bound, wkv_bwd_bound


def read(ctx, run):
    if not on_device(ctx, run):
        return None
    kernel_s = run["summary"]["group_s"]["wkv"] / units(run)
    if kernel_s <= 0:
        return None
    m, mix = ctx.model, ctx.cell.traffic
    H = m["n_heads"]
    K = m["d_model"] // H
    B, S = mix["batch"], mix["seq_len"]
    least_ms = m["n_layers"] * (wkv_bound(B, S, H, K, "bfloat16")[0]
                                + wkv_bwd_bound(B, S, H, K, "bfloat16")[0])
    return 100.0 * least_ms / 1e3 / kernel_s
