"""End-to-end convergence of the port (counterpart of
``tests/test_convergence.py``, whose batches it imports): the tiny EMRT
(ResNet-18, output stride 32, 4 classes, crop 32) trained 80 Adam steps at
lr 1e-3 with clip 1.0 on a cycle of four batches of structured synthetic
data (the label a function of the pixel's colour, in 8 x 8 blocks), at the
config's compute dtype (bf16 under autocast), must drive its loss down
(the mean of the last 5 below 0.6 x the first 5's) and beat chance on a
held-out batch (pixel accuracy above 0.5, mIoU above 0.3): the JAX test's
bounds. It catches optimizer, loss and BatchNorm wiring faults that shape
tests cannot. The card's bf16 run through the deformable kernels is
``chip_smoke.py`` phase 14 (c).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_convergence import BATCH, CROP, N_CLASSES, STEPS, _make_batch  # noqa: E402

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.losses import get_loss_function  # noqa: E402
from emrt_tpu_torch.models import get_model  # noqa: E402
from emrt_tpu_torch.solver import get_optimizer, get_scheduler  # noqa: E402
from emrt_tpu_torch.train import make_train_step  # noqa: E402
from emrt_tpu_torch.utils.metrics import confusion_matrix, mean_iou  # noqa: E402

torch.set_num_threads(1)


def _tensors(batch):
    return {"image": torch.from_numpy(np.ascontiguousarray(batch["image"].transpose(0, 3, 1, 2))),
            "label": torch.from_numpy(batch["label"]).long()}


@pytest.mark.slow
def test_emrt_converges_on_structured_data():
    cfg = get_config()
    cfg.DATA.NUM_CLASSES = N_CLASSES
    cfg.DATA.CROP_SIZE = (CROP, CROP)
    cfg.MODEL.NAME = "EMRT"
    cfg.MODEL.ENCODER.TYPE = "resnet18"
    cfg.MODEL.OUTPUT_STRIDE = 32
    cfg.TRAIN.BASE_LR = 1e-3
    cfg.TRAIN.ITERS = 100000
    cfg.TRAIN.OPTIMIZER.NAME = "Adam"
    cfg.TRAIN.OPTIMIZER.WEIGHT_DECAY = 0.0
    cfg.TRAIN.OPTIMIZER.GRAD_CLIP = 1.0

    torch.manual_seed(0)
    model = get_model(cfg, device="cpu")
    step = make_train_step(model, get_loss_function(cfg),
                           get_optimizer(cfg, model, get_scheduler(cfg)))
    rng = np.random.default_rng(0)
    _make_batch(rng)                  # the JAX test's initialisation batch
    batches = [_tensors(_make_batch(rng)) for _ in range(4)]
    losses = [step(batches[i % 4]).item() for i in range(STEPS)]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(losses).all()
    assert last < 0.6 * first, f"loss did not fall: {first:.3f} -> {last:.3f}"

    held_out = _tensors(_make_batch(np.random.default_rng(123)))
    with torch.no_grad():
        pred = model.eval()(held_out["image"])[0].argmax(1)
    cm = confusion_matrix(pred, held_out["label"], N_CLASSES).numpy()
    inter, pred_area, label_area = np.diag(cm), cm.sum(0), cm.sum(1)
    _, miou = mean_iou(inter, pred_area, label_area)
    acc = inter.sum() / label_area.sum()
    assert held_out["label"].shape[0] == BATCH
    assert acc > 0.5, f"pixel acc {acc:.3f} not above chance (0.25)"
    assert miou > 0.3, f"mIoU {miou:.3f} not above chance"
