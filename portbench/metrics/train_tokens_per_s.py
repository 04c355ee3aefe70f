"""train_tokens_per_s: tokens of every training step completed in the
window, over the window's wall time (which ends at the read of the last
step's loss)."""


def read(ctx, run):
    r = run["record"]
    return r["tokens"] / r["wall_s"] if r.get("steps") else None
