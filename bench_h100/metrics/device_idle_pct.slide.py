"""device_idle_pct.slide: the share of the traced window of
``slide_inference`` calls in which no operation ran on the device, in %."""


def read(run):
    if run.get("kind") != "slide" or "trace" not in run:
        return None
    trace = run["trace"]
    if trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
