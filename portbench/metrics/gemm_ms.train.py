"""gemm_ms.train: device ms a step in cuBLAS's matrix products
(``groups/gemm.json``), over the traced steps."""
from portbench.readings import on_device, units


def read(ctx, run):
    if not on_device(ctx, run):
        return None
    return 1e3 * run["summary"]["group_s"]["gemm"] / units(run)
