"""host_enqueue_ms.train: the host's time to enqueue one train step (the
port's ``train_step`` call returning, without waiting for the device), on
the host clock, each step after a synchronise so the launch queue never
blocks it; the mean of the traced run's ``enqueue_steps`` steps, in ms."""


def read(run):
    times = run.get("enqueue_ms") or []
    if run.get("kind") != "train" or not times:
        return None
    return sum(times) / len(times)
