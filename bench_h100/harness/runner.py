"""One run of one cell: the cell's kind (``traffic/<mix>.json``'s ``kind``,
a module of this package) sets up and measures; then, with the program's
state freed, the reference is run and the comparison decides ``correct``;
the result's line is assembled from the manifest's metrics for the cell.

A kind's ``run`` returns a dict: ``produced`` (what the timed path made
that the reference judges), ``reference`` (a function of the precision and
a planted fault that runs the reference), ``peak_bytes``, ``attempted``,
``failed``; untraced, ``e2e`` and ``setup_s``; traced, ``trace``,
``host_trace``, ``traced_units``, ``ops_per_unit``, ``tally`` and, for
training, ``enqueue_ms``. Its ``READINGS(produced, reference)`` gives the numbers
compared."""
from __future__ import annotations

import importlib
import math

import torch

from . import correct
from .common import Manifest, device_conditions, forbidden_modules, load_reader, log


class ForbiddenModules(RuntimeError):
    pass


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
             started: float, manifest: Manifest | None = None) -> dict:
    manifest = manifest or Manifest()
    cell = manifest.workload(workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(workload)
    kind = importlib.import_module(f"harness.{traffic['kind']}")
    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        log("device before:", device_conditions())
    out = kind.run(config, traffic, seed, seconds, trace, device, started, sync)
    if cuda:
        log("device after:", device_conditions())
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"modules of JAX or the JAX package are loaded: {bad}")
    reference = out["reference"]()
    readings = kind.READINGS(out["produced"], reference)
    if traffic["kind"] == "train":
        for key in ("change1", "change3"):
            for row in correct.worst_leaves(out["produced"], reference, key):
                log(f"{key} worst leaf {row[0]}: gap {row[1]:.4g}, norm {row[2]:.6g} against "
                    f"{row[3]:.6g}, first gradient {row[4]:.3g} x the median leaf's")
    ok, checks = correct.judge(readings, limits)

    if trace:
        summary, host = out["trace"], out["host_trace"]
        log(f"traced {out['traced_units']} {out['units']} in {summary.window_s:.6f} s, device "
            f"busy {summary.busy_s:.6f} s, deformable calls {out['tally'].calls}; with host "
            f"ops, {host.window_s:.6f} s, busy {host.busy_s:.6f} s, the longest idle gap "
            f"{host.longest_gap[0]:.6f} s before {host.longest_gap[1]}")
        metrics = {}
        for metric in manifest.per_layer(workload):
            value = load_reader(metric["name"])({**out, "kind": traffic["kind"]})
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        values = {**out["e2e"], "peak_mem_gib": out["peak_bytes"] / 2 ** 30,
                  "setup_s": out["setup_s"]}
        log(f"window {out['window_s']:.6f} s, {out['attempted']} {out['units']}, "
            f"set-up {out['setup_s']:.6f} s")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(workload)}
    result = {
        "correct": ok and out["failed"] == 0,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": out["peak_bytes"]},
    }
    if trace:
        result["device"]["busy_s"] = out["trace"].busy_s
        result["device"]["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown(out["host_trace"])
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    for name, value, limit in checks:
        ok_one = math.isfinite(value) and value <= limit
        log(f"check {name}: {value!r} limit {limit!r} {'ok' if ok_one else 'FAILED'}")
    return result
