"""Sliding-window inference cells: the port's
``emrt_tpu_torch.inference.slide.slide_inference`` over the eval forward's
main logits, a call being ``tiles`` tiles at once, their windows in one
model batch (as ``val.py`` runs it without a window batch).

Set-up builds the model with the seed's weights in eval mode and makes a
pool of ``pool`` calls' tiles; two calls warm every shape up. The window
runs calls over the pool in turn for ``--seconds``, each timed on the host
clock to a synchronise: ``slide_windows_per_s`` is every call's windows
over the window, ``slide_call_p95_ms`` the 95th percentile of the calls.
The logits of ``check_calls`` calls, their indices drawn from the seed
among the first ``check_within``, are kept and held to the reference after
the window.
"""
from __future__ import annotations

import random
import time

import torch

from reference.slide import window_grid

from . import seeds
from .common import mark, nearest_rank, port_config
from .correct import slide_readings
from .reference_run import Reference, reference_slide
from .trace import traced
from .yardstick import DeformTally, count_ops


def READINGS(produced, reference):
    return slide_readings(zip(produced, reference))


def make_pool(config: dict, traffic: dict, seed: int, device):
    gen = seeds.generator(seed, "inputs", device)
    return [seeds.images(gen, traffic["tiles"], tuple(traffic["tile"]), device)
            for _ in range(traffic["pool"])]


def checked_calls(traffic: dict, seed: int) -> list[int]:
    rng = random.Random(seeds.sub_seed(seed, "checked-calls"))
    return sorted(rng.sample(range(traffic["check_within"]), traffic["check_calls"]))


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        started: float, sync) -> dict:
    import emrt_tpu_torch.inference.slide as port_slide
    from emrt_tpu_torch.models import get_model
    mark(started, "torch, the harness and the port imported")
    torch.zeros(1, device=device)
    sync()
    mark(started, "the CUDA context")
    # the weights' names and shapes; on the "meta" device the init's normal_
    # would import torch._dynamo (~10 s of set-up on the card's host)
    spec = Reference(config, device).spec
    cfg = port_config(config)
    with torch.device(device):
        model = get_model(cfg, device=device)
    sync()
    mark(started, "the model built on the device")
    spec.fill_(model, seed)
    model.eval()
    sync()
    mark(started, "its seeded weights")
    pool = make_pool(config, traffic, seed, device)
    sync()
    mark(started, "the input pool")
    crop, stride = tuple(traffic["crop"]), tuple(traffic["stride"])
    classes = config["model"]["num_classes"]

    def call(k):
        return port_slide.slide_inference(lambda x: model(x)[0], pool[k % len(pool)], crop,
                                          stride, classes, traffic.get("window_batch"))

    windows = traffic["tiles"] * len(window_grid(*traffic["tile"], crop, stride))
    out = {"units": "calls"}
    want = checked_calls(traffic, seed)
    kept = {}
    with torch.inference_mode():
        for k in range(traffic["warmup_calls"]):
            call(k)
            sync()
            mark(started, f"warm-up call {k + 1}" + (" (builds the kernels)" if k == 0 else ""))
        if trace:
            out["ops_per_unit"] = count_ops(lambda: call(0), list(model.parameters()))
            tally = DeformTally()
            n = traffic["trace_calls"]

            def window(n):
                for k in range(n):
                    call(k)

            def counted():
                with tally.record():
                    window(n)
            out["trace"] = traced(counted, sync)
            out["host_trace"] = traced(lambda: window(traffic["host_trace_calls"]), sync, True)
            out["traced_units"], out["tally"] = n, tally
            for k in want:                  # the checked calls, as the window runs them
                kept[k] = call(k)
            sync()
            out["attempted"], out["failed"] = n, 0
        else:
            latencies, k = [], 0
            sync()
            t0 = time.perf_counter()
            out["setup_s"] = t0 - started
            while time.perf_counter() - t0 < seconds or k < traffic["check_within"]:
                c0 = time.perf_counter()
                logits = call(k)
                sync()
                latencies.append(time.perf_counter() - c0)
                if k in want:
                    kept[k] = logits
                k += 1
            window_s = time.perf_counter() - t0
            out["window_s"] = window_s
            out["e2e"] = {"slide_windows_per_s": k * windows / window_s,
                          "slide_call_p95_ms": nearest_rank(latencies, 0.95) * 1e3}
            out["attempted"] = k
            out["failed"] = sum(not bool(torch.isfinite(kept[j]).all()) for j in kept)
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    out["produced"] = [kept[k] for k in want]
    del model, pool, kept
    if device != "cpu":
        torch.cuda.empty_cache()
    out["reference"] = lambda precision="f32", half=False: reference_slide(
        config, traffic, seed, device, want, precision, half)
    return out
