"""ssd_roofline.prefill: the least time of the traced requests' SSD work
(one forward a layer at each request's length, ``work/ssd.py``) over the
device time of their SSD-kernel launches (``groups/ssd.json``), in %."""
from portbench.readings import on_device
from portbench.work.ssd import ssd_bound
from portbench.work.zamba2 import ssm_dims


def read(ctx, run):
    if not on_device(ctx, run):
        return None
    s = run["summary"]
    if s["group_s"]["ssd"] <= 0:
        return None
    H, P, N, _ = ssm_dims(ctx.model)
    least_ms = sum(ctx.model["n_layers"]
                   * ssd_bound(1, u["tokens"], H, P, N, "bfloat16")[0]
                   for u in s["units"])
    return 100.0 * least_ms / 1e3 / s["group_s"]["ssd"]
