"""The traced window: ``torch.profiler``'s Chrome trace reduced to what the
per-layer readers and the ``breakdown`` need.

Device time is the union of the kernels', copies' and memsets' intervals;
the window is the host clock from the synchronise before the first unit
of work to the one after the last. The metrics' window traces the device
alone: recording every host op as well costs the host some 20 us an op,
which stretched a ViT-L train step from 285 to 430-490 ms and read as
idle device time. A second, shorter window traces host ops too, and
charges each idle gap (no device activity between two device intervals)
to the innermost host op that launched the work after it.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class TraceSummary:
    def __init__(self, window_s: float, busy_s: float, by_name: dict, gaps: dict,
                 longest_gap: tuple):
        self.window_s = window_s
        self.busy_s = busy_s
        self.by_name = by_name            # device seconds by kernel name
        self.gaps = gaps                  # idle seconds by the host op after them
        self.longest_gap = longest_gap    # (seconds, host op)

    @property
    def device_s(self) -> float:
        """Device seconds summed over operations (overlaps counted twice)."""
        return sum(self.by_name.values())

    def kernel_s(self, fragment: str) -> float:
        return sum(s for name, s in self.by_name.items() if fragment in name)

    def breakdown(self, host=None) -> dict:
        """The top device ops, and the longest idle gaps by host op (of
        ``host``, a trace with host ops, where given)."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted((host or self).gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[f"idle_before_{n}", s] for n, s in gaps]}


def traced(fn, sync, host_ops: bool = False):
    """Run ``fn`` under the profiler, tracing the device's activity (and,
    with ``host_ops``, the host's ops); returns its TraceSummary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if torch.cuda.is_available():
        activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host_ops
    else:                                   # a CPU run (the tests): nothing on a device
        activities = [ProfilerActivity.CPU]
    sync()
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, window_s)


def _innermost(ops_by_tid, tid, t):
    """Name of the innermost host op on thread ``tid`` open at ``t``."""
    starts, ops = ops_by_tid.get(tid, ((), ()))
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 5000), -1):
        ts, end, name = ops[j]
        if end >= t:
            return name
    return "no_host_op"


def summarize(events, window_s: float) -> TraceSummary:
    device = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                    key=lambda e: float(e["ts"]))
    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"]] += float(e.get("dur", 0.0)) * 1e-6
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ops = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("ph") == "X":
            ts = float(e["ts"])
            ops[e.get("tid")].append((ts, ts + float(e.get("dur", 0.0)), e["name"]))
    ops_by_tid = {}
    for tid, rows in ops.items():
        rows.sort()
        ops_by_tid[tid] = ([r[0] for r in rows], rows)
    busy, gaps, longest = 0.0, defaultdict(float), (0.0, "none")
    end = None
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if end is None:
            busy += dur
            end = ts + dur
            continue
        if ts > end:
            launch = launches.get(e.get("args", {}).get("correlation"))
            name = (_innermost(ops_by_tid, launch.get("tid"), float(launch["ts"]))
                    if launch else "no_launch")
            gap = (ts - end) * 1e-6
            gaps[name] += gap
            if gap > longest[0]:
                longest = (gap, name)
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return TraceSummary(window_s, busy * 1e-6, dict(by_name), dict(gaps), longest)
