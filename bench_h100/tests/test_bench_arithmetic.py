"""The rate, percentile, roofline, MFU, idle and comparison arithmetic on
hand-made inputs."""
from __future__ import annotations

import math

import pytest
import torch

from harness import correct
from harness.common import load_reader, nearest_rank
from harness.trace import summarize
from harness.yardstick import DeformTally, bwd_ops, fwd_ops, nbytes


def test_nearest_rank_p95():
    values = list(range(1, 101))              # 1..100
    assert nearest_rank(values, 0.95) == 95
    assert nearest_rank([3.0, 1.0, 2.0], 0.95) == 3.0
    assert nearest_rank([5.0], 0.95) == 5.0
    assert nearest_rank(list(range(20)), 0.95) == 18


def test_deformable_bytes_and_ops():
    value = torch.zeros(2, 1344, 8, 32, dtype=torch.bfloat16)
    loc = torch.zeros(2, 1344, 8, 3, 6, 2)
    attn = torch.zeros(2, 1344, 8, 3, 6, dtype=torch.bfloat16)
    out = torch.zeros(2, 1344, 256, dtype=torch.bfloat16)
    samples = 2 * 1344 * 8 * 3 * 6
    assert nbytes((value, loc, attn, out)) == (value.numel() * 2 + loc.numel() * 4
                                               + attn.numel() * 2 + out.numel() * 2)
    assert fwd_ops(value, loc) == 8 * 32 * samples
    assert bwd_ops(value, loc) == 16 * 32 * samples


class _Trace:
    def __init__(self, window_s, busy_s, by_name):
        self.window_s, self.busy_s, self.by_name = window_s, busy_s, by_name

    @property
    def device_s(self):
        return sum(self.by_name.values())

    def kernel_s(self, fragment):
        return sum(s for n, s in self.by_name.items() if fragment in n)


def _run(kind, **kw):
    tally = DeformTally()
    tally.bytes = {"fwd": 3.35e9, "bwd": 6.7e9}
    trace = _Trace(2.0, 1.5, {"void ms_deform_attn_fwd_kernel<bf16>": 0.01,
                              "void ms_deform_attn_bwd_kernel<bf16>": 0.04,
                              "upsample_bilinear2d_backward_out_frame": 0.3,
                              "gemm": 1.15})
    return {"kind": kind, "trace": trace, "tally": tally, "traced_units": 4,
            "ops_per_unit": 98.9e12, **kw}


def test_readers_on_hand_made_runs():
    train = _run("train", enqueue_ms=[100.0, 120.0])
    # 4 steps of 98.9e12 operations in 2 s at 989e12 FLOP/s: 20%
    assert load_reader("mfu.train")(train) == pytest.approx(20.0)
    assert load_reader("mfu.slide")(train) is None
    # 6.7e9 bytes at 3.35e12 bytes/s is 2 ms, over 40 ms of kernel: 5%
    assert load_reader("deform_bwd_roofline.train")(train) == pytest.approx(5.0)
    assert load_reader("resize_pct.train")(train) == pytest.approx(100 * 0.3 / 1.5)
    assert load_reader("device_idle_pct.train")(train) == pytest.approx(25.0)
    assert load_reader("host_enqueue_ms.train")(train) == pytest.approx(110.0)
    slide = _run("slide")
    assert load_reader("deform_fwd_roofline.slide")(slide) == pytest.approx(10.0)
    assert load_reader("device_idle_pct.slide")(slide) == pytest.approx(25.0)
    assert load_reader("host_enqueue_ms.train")(slide) is None


def test_readers_find_nothing_without_device_time():
    run = _run("train", enqueue_ms=[1.0])
    run["trace"] = _Trace(2.0, 0.0, {})
    for name in ("mfu.train", "deform_bwd_roofline.train", "resize_pct.train",
                 "device_idle_pct.train"):
        assert load_reader(name)(run) is None


def test_trace_summary_busy_and_gaps():
    def kernel(ts, dur, corr, name="k"):
        return {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur, "name": name,
                "args": {"correlation": corr}}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "ts": ts, "dur": 1, "tid": 7,
                "name": "cudaLaunchKernel", "args": {"correlation": corr}}

    events = [
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 1000, "tid": 7, "name": "outer"},
        {"ph": "X", "cat": "cpu_op", "ts": 400, "dur": 50, "tid": 7, "name": "aten::copy_"},
        launch(10, 1), kernel(100, 100, 1),
        launch(150, 2), kernel(150, 100, 2),        # overlaps the first: no gap
        launch(410, 3), kernel(450, 50, 3, "b"),    # a 200 us gap after 250
    ]
    s = summarize(events, window_s=0.001)
    assert s.busy_s == pytest.approx(200e-6)
    assert s.gaps == {"aten::copy_": pytest.approx(200e-6)}
    assert s.longest_gap == (pytest.approx(200e-6), "aten::copy_")
    assert s.by_name == {"k": pytest.approx(200e-6), "b": pytest.approx(50e-6)}
    b = s.breakdown()
    assert b["idle_gaps"] == [["idle_before_aten::copy_", pytest.approx(200e-6)]]
    assert b["device_ops"][0][0] == "k"


def test_train_readings_worst_leaf_and_small_leaves():
    ref = {"losses": [2.0, 1.9, 1.8], "change1": torch.tensor([1.0, 2.0, 3.0, 1e-9]),
           "change3": torch.tensor([2.0, 4.0, 6.0, 1e-9]),
           "grad1": torch.tensor([1.0, 1.0, 1.0, 1e-6]), "logits": torch.tensor([3.0, 4.0])}
    prog = {"losses": [2.002, 1.9, 1.8], "change1": torch.tensor([1.1, 2.0, 3.0, 5.0]),
            "change3": torch.tensor([2.0, 4.0, 6.6, 7.0]), "logits": torch.tensor([3.0, 4.5])}
    r = correct.train_readings(prog, ref)
    assert r["loss_gap"] == pytest.approx(1e-3)
    assert r["logit_gap"] == pytest.approx(0.5 / 5.0)
    assert r["grad_gap_median"] == pytest.approx(0.0)    # leaves 0-2 read 0.05, 0, 0
    assert r["change_gap_median"] == pytest.approx(0.0)
    # leaf 0 against the median leaf (2.0): 0.1 / 2; the last leaf left out
    assert r["grad_gap"] == pytest.approx(0.05)
    assert r["change_gap"] == pytest.approx(0.1)
    unchanged = {**prog, "change1": torch.zeros(4), "change3": torch.zeros(4)}
    assert correct.train_readings(unchanged, ref)["change_gap"] == pytest.approx(1.0)
    assert correct.train_readings(unchanged, ref)["change_gap_median"] == pytest.approx(1.0)
    halved = {**prog, "logits": torch.tensor([3.0])}
    assert correct.train_readings(halved, ref)["logit_gap"] == math.inf


def test_slide_readings():
    ref = torch.zeros(1, 3, 2, 2)
    ref[:, 0] = 1.0
    same = correct.slide_readings([(ref.clone(), ref)])
    assert same == {"rms_gap": 0.0, "argmax_gap": 0.0}
    wrong = ref.clone()
    wrong[0, 1, 0, 0] = 2.0        # one pixel now predicts class 1, a gap of 1
    r = correct.slide_readings([(wrong, ref)])
    rms = math.sqrt(4 / 12)
    assert r["argmax_gap"] == pytest.approx(1.0 / rms)
    assert r["rms_gap"] == pytest.approx(2.0 / 2.0)
    nan = ref.clone()
    nan[0, 0, 0, 0] = float("nan")
    assert correct.slide_readings([(nan, ref)])["rms_gap"] == math.inf


def test_judge():
    ok, checks = correct.judge({"a": 0.1, "b": 0.2}, {"a": 0.5, "b": 0.2})
    assert ok and checks == [("a", 0.1, 0.5), ("b", 0.2, 0.2)]
    assert not correct.judge({"a": 0.6}, {"a": 0.5})[0]
    assert not correct.judge({"a": math.nan}, {"a": 0.5})[0]
    assert not correct.judge({}, {"a": 0.5})[0]
