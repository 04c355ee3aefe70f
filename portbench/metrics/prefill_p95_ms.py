"""prefill_p95_ms: the 95th percentile (nearest rank) of the latency of
every request completed in the window, from its send to its logits on the
host."""
from portbench.readings import nearest_rank


def read(ctx, run):
    lat = run["record"].get("latency_s")
    return 1e3 * nearest_rank(lat, 0.95) if lat else None
