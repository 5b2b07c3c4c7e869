"""Running the reference (``bench_h100/reference``) where the harness needs
it: its module tree for the weights' names and shapes, and its training
steps and sliding-window inference on the seed's weights and inputs,
remade from the seed, after the program's state has been freed."""
from __future__ import annotations

import torch

from reference.model import EMRT, norm_parameters, residual_norm_parameters
from reference.ops import Precision, exact_float32
from reference.slide import slide
from reference.solver import SGD, loss_fn

from . import seeds

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Reference:
    """The reference model on ``device`` in ``precision``, and the spec of
    its weights."""

    def __init__(self, config: dict, device, precision: str = "f32"):
        spec = config["model"]
        with torch.device(device):
            self.model = EMRT(spec, Precision(precision), draw_dtype=DTYPES[spec["dtype"]])
        self.spec = seeds.WeightSpec.of(self.model, norm_parameters(self.model),
                                        residual_norm_parameters(self.model))


@torch.no_grad()
def change_norms(model, spec, seed: int) -> torch.Tensor:
    """Each leaf's ||p - p0|| (p0 the seed's weights), in ``spec``'s order,
    on the host."""
    params = dict(model.named_parameters())
    p0 = spec.values(seed, next(iter(params.values())).device)
    norms = torch.stack([(params[n].float() - p0[n]).norm() for n in spec.names()])
    return norms.double().cpu()


def reference_train(config: dict, traffic: dict, seed: int, device, precision: str = "f32",
                    half: bool = False) -> dict:
    """The reference's first ``check_steps`` steps: {"losses", "change1",
    "change3", "grad1", "logits"} (the first step's main logits). ``half``:
    the fault of a step that leaves out half of each batch and takes the mean
    over the rest."""
    from .train import dropout_seed, make_pool
    ref = Reference(config, device, precision)
    model, spec = ref.model, ref.spec
    spec.fill_(model, seed)
    model.train()
    if hasattr(model, "encoder"):
        model.encoder.transformer.checkpoint = True
    sgd = SGD(model.named_parameters(), config["solver"])
    pool = make_pool(config, traffic, seed, device, n=traffic["check_steps"])
    out = {"losses": []}
    with exact_float32():
        for i, batch in enumerate(pool):
            image, label = batch["image"], batch["label"]
            if half:
                image, label = image[:len(image) // 2], label[:len(label) // 2]
            torch.manual_seed(dropout_seed(seed, i))
            for p in model.parameters():
                p.grad = None
            outputs = model(image)
            if i == 0:
                out["logits"] = outputs[0].detach().clone()
            loss = loss_fn(outputs, label, config["solver"])
            loss.backward()
            if i == 0:
                params = dict(model.named_parameters())
                out["grad1"] = torch.stack([
                    params[n].grad.float().norm() if params[n].grad is not None
                    else torch.zeros((), device=image.device) for n in spec.names()]).double().cpu()
            sgd.step()
            out["losses"].append(float(loss.detach()))
            if i == 0:
                out["change1"] = change_norms(model, spec, seed)
    out["change3"] = change_norms(model, spec, seed)
    return out


def reference_slide(config: dict, traffic: dict, seed: int, device, calls,
                    precision: str = "f32", half: bool = False):
    """The reference's logits of the pool entries ``calls`` (indices), each
    [tiles, C, H, W]. ``half``: the fault of a call that leaves out half of
    its tiles."""
    from .slide import make_pool
    ref = Reference(config, device, precision)
    ref.spec.fill_(ref.model, seed)
    model = ref.model.eval()
    pool = make_pool(config, traffic, seed, device)
    m = config["model"]
    out = []
    with exact_float32(), torch.no_grad():
        for j in calls:
            imgs = pool[j % len(pool)]
            logits = slide(lambda x: model(x)[0], imgs, tuple(traffic["crop"]),
                           tuple(traffic["stride"]), m["num_classes"],
                           traffic["reference_windows"])
            if half:
                logits[len(logits) // 2:] = 0.0
            out.append(logits)
    return out
