"""resize_pct.train: the share of the traced steps' device time spent in
bilinear resize kernels (``upsample_bilinear2d`` forward and backward), in
%, of all device operations' time."""


def read(run):
    if run.get("kind") != "train" or "trace" not in run:
        return None
    trace = run["trace"]
    if trace.busy_s <= 0:
        return None
    return 100.0 * trace.kernel_s("upsample_bilinear2d") / trace.device_s
