"""What every cell shares: the manifest and the files it names, the
program's configuration, the device's conditions, the check that no JAX
module was loaded, and the arithmetic of rates and percentiles."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]        # bench_h100/
ROOT = BENCH.parent                                # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "emrt_tpu")  # whole top-level names
CACHE_VARS = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "TORCHINDUCTOR_CACHE_DIR")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def mark(started: float, what: str):
    """Log how far into the run (seconds since ``started``) ``what`` ended."""
    log(f"set-up: {what} at {time.perf_counter() - started:.3f} s")


def set_cache_dirs(root: Path = ROOT):
    """Fixed build and kernel cache directories inside the checkout, so that
    a checkout's first run builds and the later ones find it all built.
    (The port builds its own kernels under ``emrt_tpu_torch/_build``.)"""
    base = root / ".bench_cache"
    for var in CACHE_VARS:
        os.environ[var] = str(base / var.lower())
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``emrt_tpu_torch`` is not ``emrt_tpu``)."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


class Manifest:
    """``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / BENCH.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(c['name'] for c in self.data['workloads'])})")

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.bench / "limits" / f"{workload}.json").read_text())

    def reports(self, cell: str, metric: dict) -> bool:
        """Whether ``cell`` reports ``metric`` (a manifest entry)."""
        if "workloads" in metric:
            return cell in metric["workloads"]
        moves = metric.get("moves")
        if moves is None:
            return True
        target = next(m for m in self.data["end_to_end"] if m["name"] == moves)
        return self.reports(cell, target)

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if self.reports(cell, m)]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"] if self.reports(cell, m)]


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(config: dict):
    """The program's configuration node: its defaults, then the yaml's
    settings as the configuration file holds them."""
    from emrt_tpu_torch.config import get_config
    node = get_config()
    node.defrost()
    node.merge_from_dict(config["yaml"])
    node.freeze()
    return node


def device_conditions() -> dict:
    """The card's name, power limit, SM clock, temperature and power draw
    as ``nvidia-smi`` reads them now; {} where it cannot."""
    fields = ("name", "power.limit", "clocks.sm", "clocks.max.sm", "temperature.gpu",
              "power.draw")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(fields, (v.strip() for v in out.split(","))))


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q <= 1) of ``values`` by nearest rank: the
    smallest value with at least q of them at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]
