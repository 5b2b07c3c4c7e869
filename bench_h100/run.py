"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The cell, its configuration and its traffic are found by
name (``BENCHMARK.json``, ``bench_h100/configs``, ``bench_h100/traffic``),
its limits in ``bench_h100/limits``, its per-layer readers in
``bench_h100/metrics``. Prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``, each number
compared beside its limit, which also end standard error.

Exits with 2 and prints no result where CUDA or the cards are missing, and
with 3 where a module of JAX or of the JAX package got loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

from harness.common import Manifest, log, set_cache_dirs  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_cache_dirs()
    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from harness.runner import ForbiddenModules, run_cell
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                          STARTED, manifest)
    except ForbiddenModules as exc:
        log(str(exc))
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
