"""batch_host_ms.train: host ms a step to build the step's rows and upload
them (the train loop's and the data pipeline's share of a step), the mean
over the window's steps."""


def read(ctx, run):
    hs = run["record"].get("batch_host_s")
    return 1e3 * sum(hs) / len(hs) if hs else None
