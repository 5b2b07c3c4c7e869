"""Whole runs of each cell at a tiny size on the CPU (the look for a card
skipped): ``correct`` true as the program stands, false with the timed
path broken underneath (each fault a cell can have), and false for the
control, the reference in float8 in the program's place."""
from __future__ import annotations

import importlib
import time

import pytest
import torch

import emrt_tpu_torch.inference.slide as port_slide
import emrt_tpu_torch.train as port_train
from emrt_tpu_torch.solver.optimizer import _ScheduledOptimizer
from harness import correct
from harness.runner import run_cell

CELLS = ("emrt_r50.train_bs64", "emrt_vitl.train_bs64", "emrt_r50.slide_4x1024",
         "emrt_vitl.slide_4x1024")


def run(tiny, cell, seed=11, trace=False):
    return run_cell(cell, seed, 0.2, trace, "cpu", time.perf_counter(), tiny)


@pytest.mark.parametrize("cell", CELLS)
def test_correct_as_the_program_stands(tiny, cell):
    result = run(tiny, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in tiny.end_to_end(cell)}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"


def test_traced_run(tiny):
    result = run(tiny, "emrt_r50.train_bs64", seed=2 ** 31 + 5, trace=True)
    assert result["correct"] and "breakdown" in result
    assert result["metrics"]["host_enqueue_ms.train"]["value"] > 0
    assert "window_s" in result["device"]


def _unchanged(monkeypatch):
    monkeypatch.setattr(_ScheduledOptimizer, "step", lambda self: None)


def _half_batch(monkeypatch):
    make = port_train.make_train_step

    def halved(model, loss_fn, optimizer):
        step = make(model, loss_fn, optimizer)
        return lambda batch: step({k: v[:len(v) // 2] for k, v in batch.items()})
    monkeypatch.setattr(port_train, "make_train_step", halved)


def _half_tiles(monkeypatch):
    slide = port_slide.slide_inference

    def halved(forward, imgs, *args, **kw):
        out = slide(forward, imgs, *args, **kw)
        out[len(out) // 2:] = 0.0
        return out
    monkeypatch.setattr(port_slide, "slide_inference", halved)


def _altered_answer(monkeypatch):
    slide = port_slide.slide_inference

    def altered(forward, imgs, crop, *args, **kw):
        out = slide(forward, imgs, crop, *args, **kw)
        rms = out.square().mean().sqrt()
        out[0, 1, :crop[1], :crop[0]] += 10 * rms      # one window's class 1
        return out
    monkeypatch.setattr(port_slide, "slide_inference", altered)


FAULTS = [("emrt_r50.train_bs64", _unchanged), ("emrt_r50.train_bs64", _half_batch),
          ("emrt_vitl.train_bs64", _unchanged), ("emrt_vitl.train_bs64", _half_batch),
          ("emrt_r50.slide_4x1024", _half_tiles), ("emrt_r50.slide_4x1024", _altered_answer),
          ("emrt_vitl.slide_4x1024", _half_tiles),
          ("emrt_vitl.slide_4x1024", _altered_answer)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run(tiny, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    """The reference with its matmuls and convolutions in float8 e4m3, held
    to the float32 reference by the cell's limits."""
    config = tiny.config(tiny.workload(cell)["config"])
    traffic = tiny.traffic(tiny.workload(cell)["traffic"])
    kind = importlib.import_module(f"harness.{traffic['kind']}")
    if traffic["kind"] == "train":
        refs = [kind.reference_train(config, traffic, 3, "cpu", p) for p in ("fp8", "f32")]
    else:
        calls = kind.checked_calls(traffic, 3)
        refs = [kind.reference_slide(config, traffic, 3, "cpu", calls, p) for p in ("fp8", "f32")]
    ok, checks = correct.judge(kind.READINGS(*refs), tiny.limits(cell))
    assert not ok, checks


@pytest.mark.cuda
def test_on_the_card(card):
    """One short run of the R50 slide cell through ``run.py``'s entry on a card."""
    import json
    import subprocess
    import sys

    from conftest import ROOT
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                          "emrt_r50.slide_4x1024", "--seed", "7", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert torch.cuda.device_count() >= 1
