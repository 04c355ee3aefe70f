"""adamw_ms.train: device ms of one ``adamw_update``: the kernels launched
inside the harness's span around the train step's optimizer call, over
the traced steps."""
from portbench.readings import on_device, units


def read(ctx, run):
    if not on_device(ctx, run):
        return None
    s = run["summary"]["span_s"].get("adamw")
    return 1e3 * s / units(run) if s else None
