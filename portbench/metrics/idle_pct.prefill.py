"""idle_pct.prefill: the device's idle share of the window's requests, in %: one
less the device's busy time a token in the traced requests (the union of its
kernels, copies and sets) times the tokens a second of the requests before
the traced stretch.  The profiler slows the host, so the stretch's own
wall time would overstate it."""
from portbench.readings import idle_pct, on_device


def read(ctx, run):
    return idle_pct(run) if on_device(ctx, run) else None
