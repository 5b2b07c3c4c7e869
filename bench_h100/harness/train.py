"""Training cells: the port's train step (``emrt_tpu_torch.train.make_train_step``
with its optimizer, schedule and loss from the configuration) on batches
made on the device from the seed.

Set-up builds the model and step once, fills the seeded weights, makes a
pool of ``pool`` batches and drives the step through the pool's first
``check_steps`` batches (the default generator seeded from the run's seed
before each, for dropout): those steps are the warm-up of every shape the
window uses, and their losses and per-leaf updates are what the reference
is held to after the window. The window then runs the same step object
over the pool in turn, without a synchronise, for ``--seconds``, and is
closed by one: ``train_images_per_s`` is every step's images over it.

A traced run instead counts one step's operations, profiles
``trace_steps`` steps and then times ``enqueue_steps`` steps' enqueue alone
on the host clock, each after a synchronise.
"""
from __future__ import annotations

import time

import torch

from . import seeds
from .common import mark, port_config
from .correct import train_readings
from .reference_run import Reference, change_norms, reference_train
from .trace import traced
from .yardstick import DeformTally, count_ops


READINGS = train_readings


def make_pool(config: dict, traffic: dict, seed: int, device, n: int | None = None):
    gen = seeds.generator(seed, "inputs", device)
    crop = tuple(config["model"]["crop"])[::-1]          # (w, h) -> (h, w)
    pool = []
    for _ in range(traffic["pool"] if n is None else n):
        image = seeds.images(gen, traffic["batch"], crop, device)
        label = seeds.smooth_labels(gen, traffic["batch"], config["model"]["num_classes"],
                                    crop, traffic["label_cell"], device)
        pool.append({"image": image, "label": label})
    return pool


def dropout_seed(seed: int, step: int) -> int:
    return seeds.sub_seed(seed, f"dropout-{step}")


def build_program(config: dict, spec, seed: int, device, started: float, sync):
    """(model, train_step, optimizer) of the port, with the seed's weights."""
    import emrt_tpu_torch.train as port_train
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    mark(started, "the port imported")
    torch.zeros(1, device=device)
    sync()
    mark(started, "the CUDA context")
    cfg = port_config(config)
    with torch.device(device):
        model = get_model(cfg, device=device)
    sync()
    mark(started, "the model built on the device")
    spec.fill_(model, seed)
    optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
    return model, port_train.make_train_step(model, get_loss_function(cfg), optimizer), optimizer


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        started: float, sync) -> dict:
    mark(started, "torch and the harness imported")
    # the weights' names and shapes; on the "meta" device the init's normal_
    # would import torch._dynamo (~10 s of set-up on the card's host)
    spec = Reference(config, device).spec
    model, step, optimizer = build_program(config, spec, seed, device, started, sync)
    sync()
    mark(started, "its seeded weights")
    pool = make_pool(config, traffic, seed, device)
    sync()
    mark(started, "the input pool")
    checked = traffic["check_steps"]
    prog = {"losses": [], "names": spec.names()}

    def keep_logits(module, args, outputs):     # the first step's, as its forward made them
        prog["logits"] = outputs[0].detach().clone()

    for i in range(checked):
        torch.manual_seed(dropout_seed(seed, i))
        hook = model.register_forward_hook(keep_logits) if i == 0 else None
        prog["losses"].append(step(pool[i]))
        if hook is not None:
            hook.remove()
            prog["change1"] = change_norms(model, spec, seed)
        mark(started, f"checked step {i + 1}" + (" (builds the kernels)" if i == 0 else ""))
    prog["losses"] = [float(v) for v in prog["losses"]]
    prog["change3"] = change_norms(model, spec, seed)
    out = {"units": "steps", "produced": prog}
    batch = traffic["batch"]
    if trace:
        out["ops_per_unit"] = count_ops(lambda: step(pool[0]))
        tally = DeformTally()
        n = traffic["trace_steps"]

        def window(n):
            for k in range(n):
                step(pool[k % len(pool)])

        def counted():
            with tally.record():
                window(n)
        out["trace"] = traced(counted, sync)
        out["host_trace"] = traced(lambda: window(traffic["host_trace_steps"]), sync, True)
        out["traced_units"], out["tally"] = n, tally
        enqueue = []
        for k in range(traffic["enqueue_steps"]):
            sync()
            t0 = time.perf_counter()
            step(pool[k % len(pool)])
            enqueue.append((time.perf_counter() - t0) * 1e3)
            sync()
        out["enqueue_ms"] = enqueue
        out["attempted"], out["failed"] = n, 0
    else:
        losses, k = [], checked
        sync()
        t0 = time.perf_counter()
        out["setup_s"] = t0 - started
        while True:
            losses.append(step(pool[k % len(pool)]))
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        steps = k - checked
        out["window_s"] = window_s
        out["e2e"] = {"train_images_per_s": steps * batch / window_s}
        out["attempted"] = steps
        out["failed"] = int((~torch.isfinite(torch.stack(losses))).sum())
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del model, step, optimizer, pool
    if device != "cpu":
        torch.cuda.empty_cache()
    out["reference"] = lambda precision="f32", half=False: reference_train(
        config, traffic, seed, device, precision, half)
    return out
