"""Training timers (counterpart of ``emrt_tpu/utils/timer.py``; reference
semantic_segmentation/src/utils/timer.py:17-51)."""
from __future__ import annotations

import time


class TimeAverager:
    """Windowed average of batch cost and samples/sec."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total_time = 0.0
        self._total_samples = 0
        self._cnt = 0

    def record(self, usetime: float, num_samples: int | None = None):
        self._total_time += usetime
        self._cnt += 1
        if num_samples:
            self._total_samples += num_samples

    def get_average(self) -> float:
        return self._total_time / self._cnt if self._cnt else 0.0

    def get_ips_average(self) -> float:
        return self._total_samples / self._total_time if self._total_time else 0.0


def calculate_eta(remaining_iters: int, speed: float) -> str:
    """Remaining wall-clock as HH:MM:SS given sec/iter speed."""
    remaining_time = int(max(remaining_iters, 0) * speed)
    hours, rest = divmod(remaining_time, 3600)
    minutes, seconds = divmod(rest, 60)
    return f"{hours:02d}:{minutes:02d}:{seconds:02d}"


class Timer:
    def __init__(self):
        self._start = time.time()

    def elapsed(self) -> float:
        return time.time() - self._start

    def restart(self) -> float:
        now = time.time()
        out = now - self._start
        self._start = now
        return out
