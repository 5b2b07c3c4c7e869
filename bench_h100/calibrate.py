"""The readings that the limits of a cell are set from, in one process.

    python3 bench_h100/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--fault-seeds 7 8 9] [--look-seeds 5 6] \
        [--seconds 1] [--out file.jsonl]

For each of ``--seeds``: a run of the cell as ``run.py`` makes it (its
set-up, a window of ``--seconds``, the reference after it) and the numbers
compared, the lower readings. For each of ``--control-seeds``: the
control, the reference computed with every matmul and convolution in
float8 e4m3 (one step below the configurations' bfloat16) in the
program's place, against the float32 reference: the upper readings. For
each of ``--fault-seeds``: the reference with a planted fault in the
program's place against the reference, half of each batch (training) or
of each call's tiles (inference) left out. For each of ``--look-seeds``:
the reference with bfloat16 matmuls and convolutions, and the float32
reference run again, against the float32 reference: what bfloat16 itself,
and the card's run-to-run order of sums, do to each number. Prints one
JSON line per reading, and writes them to ``--out`` where given.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

from harness.common import Manifest, log, set_cache_dirs  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--look-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        log("calibrate.py needs a CUDA card")
        return 2
    manifest = Manifest()
    cell = manifest.workload(args.workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    kind = importlib.import_module(f"harness.{traffic['kind']}")
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def reference(seed, precision="f32", half=False):
        if traffic["kind"] == "train":
            return kind.reference_train(config, traffic, seed, "cuda", precision, half)
        return kind.reference_slide(config, traffic, seed, "cuda",
                                    kind.checked_calls(traffic, seed), precision, half)

    for seed in args.seeds:
        t0 = time.perf_counter()
        out = kind.run(config, traffic, seed, args.seconds, False, "cuda", t0,
                       torch.cuda.synchronize)
        readings = kind.READINGS(out["produced"], out["reference"]())
        emit({"what": "program", "seed": seed, **readings,
              "e2e": out["e2e"], "seconds": time.perf_counter() - t0})
        del out
        torch.cuda.empty_cache()
    for tag, seeds, opts in (("control", args.control_seeds, {"precision": "fp8"}),
                             ("half", args.fault_seeds, {"half": True}),
                             ("look bf16", args.look_seeds, {"precision": "bf16"}),
                             ("look f32 again", args.look_seeds, {})):
        for seed in seeds:
            t0 = time.perf_counter()
            exact = reference(seed)
            planted = reference(seed, **opts)
            emit({"what": tag, "seed": seed, **kind.READINGS(planted, exact),
                  "seconds": time.perf_counter() - t0})
            del exact, planted
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps({"workload": args.workload, **row}) + "\n")
    log(f"calibrate.py: {len(rows)} readings in {time.perf_counter() - STARTED:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
