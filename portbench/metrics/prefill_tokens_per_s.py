"""prefill_tokens_per_s: the prompt tokens of every request completed in
the window, over the window."""


def read(ctx, run):
    r = run["record"]
    return r["tokens"] / r["wall_s"] if r.get("requests") else None
