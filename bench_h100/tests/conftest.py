"""A tiny copy of the benchmark for CPU runs: the same manifest, configs
and traffic at 64^2 crops, float32, a narrow ViT and two tiles of 128^2,
with limits for float32 against float32 at that size."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)      # several test workers share the cores

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for path in (str(BENCH), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

# float32 against float32 at 64^2 and batch 2 (BatchNorm over a few values
# a channel amplifies rounding) read up to 3e-7 (loss), 1e-6 (the first
# logits), 1e-3 (the worst leaf's first update and change), 1e-7 (slide
# logits)
TINY_LIMITS = {"train": {"loss_gap": 1e-4, "logit_gap": 1e-4, "grad_gap": 1e-2,
                         "change_gap": 1e-2, "grad_gap_median": 1e-3,
                         "change_gap_median": 1e-3},
               "slide": {"rms_gap": 1e-4, "argmax_gap": 1e-3}}


def make_tiny(dst: Path) -> Path:
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / BENCH.name).mkdir(parents=True)
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(BENCH / sub, dst / BENCH.name / sub)
    for entry in manifest["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        cfg["yaml"]["DATA"]["CROP_SIZE"] = "(64, 64)"
        cfg["yaml"].setdefault("TRAIN", {})["DTYPE"] = "float32"
        cfg["model"].update({"crop": [64, 64], "dtype": "float32"})
        if "vit" in cfg["model"]:
            cfg["yaml"]["MODEL"]["TRANS"].update({"HIDDEN_SIZE": 64, "NUM_LAYERS": 4,
                                                  "NUM_HEADS": 2})
            cfg["yaml"]["MODEL"]["ENCODER"]["OUT_INDICES"] = [0, 1, 2, 3]
            cfg["model"]["vit"].update({"hidden": 64, "layers": 4, "heads": 2,
                                        "out_indices": [0, 1, 2, 3]})
        (dst / entry["file"]).write_text(json.dumps(cfg))
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = dst / BENCH.name / "traffic"
    for path in traffic.glob("*.json"):
        mix = json.loads(path.read_text())
        if mix["kind"] == "train":
            mix.update(batch=2, trace_steps=2, host_trace_steps=1, enqueue_steps=2)
        else:
            mix.update(tiles=2, tile=[128, 128], crop=[64, 64], stride=[43, 43],
                       check_within=3, reference_windows=4, trace_calls=2,
                       host_trace_calls=1)
        path.write_text(json.dumps(mix))
    for cell in manifest["workloads"]:
        kind = json.loads((traffic / f"{cell['traffic']}.json").read_text())["kind"]
        (dst / BENCH.name / "limits" / f"{cell['name']}.json").write_text(
            json.dumps(TINY_LIMITS[kind]))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    from harness.common import Manifest
    return Manifest(make_tiny(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
