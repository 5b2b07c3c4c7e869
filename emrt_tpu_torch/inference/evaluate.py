"""Validation loop: sliding-window eval + streaming confusion metrics
(counterpart of ``emrt_tpu/inference/evaluate.py``; reference
val_in_train.py:19-125 and the val.py body).

A batch is padded to DATA.BATCH_SIZE_VAL with copies whose labels are all
ignore_index. A batch of one shape is predicted single-scale
(``ss_inference``, with VAL.RESCALE_FROM_ORI) or with multi-scale +
horizontal-flip TTA (``ms_inference``, VAL.SCALE_RATIOS); a batch of mixed
shapes goes through ``_variable_shape_predict``. The int64 confusion matrix
accumulates on the device.

Under data parallelism (the JAX package's mesh path, ``evaluate.py:104-141``;
reference val.py:164-180) data rank r of N predicts the batches j = r (mod
N), each as one process would build it (so the mixed-shape canvas and the
padding are the same), and the confusion areas and image counts of the
data group are summed: every rank returns the one-process result. The
ranks of a model group (``parallel/mesh.py``) predict the same batches
together.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..data.loader import val_batches
from ..ops.resize import batched_resize_bilinear_padded, resize_bilinear
from ..parallel.mesh import all_reduce_data, data_rank, data_world, is_main
from ..utils.logger import logger
from ..utils.metrics import MetricAccumulator, confusion_matrix
from .slide import ms_inference, slide_inference, ss_inference


def build_val_transforms(config):
    from ..data.transforms import Normalize, Resize
    tfms = []
    if config.VAL.IMAGE_BASE_SIZE:
        size = config.VAL.IMAGE_BASE_SIZE
        if isinstance(size, int):
            size = (size, size)
        tfms.append(Resize(target_size=tuple(size),
                           keep_ori_size=config.VAL.KEEP_ORI_SIZE))
    tfms.append(Normalize(mean=config.VAL.MEAN, std=config.VAL.STD))
    return tfms


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _variable_shape_predict(forward, imgs, labels, config, multi_scales, crop_size,
                            stride_size, num_classes, ignore_index, window_batch, device):
    """A batch of mixed shapes (reference multi_batch_collate.py:17-29,
    infer.py:82-157): the images go top left into one canvas of 128-aligned
    size (at least the crop), the labels into one of ignore_index; the
    canvas is slid over at each scale (and flipped, with TTA), and each
    image's logits region is resized to its own label's size. Without TTA
    the raw logits are summed, with it their softmax. Returns (predictions,
    labels), both [bs, Hl, Wl] on ``device``."""
    hb = max(crop_size[1], _round_up(max(im.shape[0] for im in imgs), 128))
    wb = max(crop_size[0], _round_up(max(im.shape[1] for im in imgs), 128))
    lab2 = [np.asarray(lb).reshape(lb.shape[-2:]) for lb in labels]
    hlb = _round_up(max(lb.shape[0] for lb in lab2), 128)
    wlb = _round_up(max(lb.shape[1] for lb in lab2), 128)

    img_canvas = np.zeros((len(imgs), hb, wb, imgs[0].shape[-1]), np.float32)
    lab_canvas = np.full((len(imgs), hlb, wlb), ignore_index, np.int64)
    for i, (im, lb) in enumerate(zip(imgs, lab2)):
        img_canvas[i, :im.shape[0], :im.shape[1]] = im
        lab_canvas[i, :lb.shape[0], :lb.shape[1]] = lb
    img_batch = torch.from_numpy(img_canvas).to(device).permute(0, 3, 1, 2).contiguous()
    src_hw = [im.shape[:2] for im in imgs]
    dst_hw = [lb.shape for lb in lab2]

    scales = tuple(config.VAL.SCALE_RATIOS) if multi_scales else (1.0,)
    flips = [False, True] if multi_scales else [False]
    final = torch.zeros((len(imgs), num_classes, hlb, wlb), dtype=torch.float32,
                        device=device)
    for scale in scales:
        if scale != 1.0:
            scaled = resize_bilinear(img_batch, (int(hb * scale + 0.5), int(wb * scale + 0.5)))
            # round half to even, as jnp.round
            s_src = [(round(h * scale), round(w * scale)) for h, w in src_hw]
        else:
            scaled, s_src = img_batch, src_hw
        for flip in flips:
            x = torch.flip(scaled, (3,)) if flip else scaled
            logits = slide_inference(forward, x, crop_size, stride_size, num_classes,
                                     window_batch)
            if flip:
                logits = torch.flip(logits, (3,))
            resized = batched_resize_bilinear_padded(logits, s_src, dst_hw, (hlb, wlb))
            final += resized.softmax(dim=1) if multi_scales else resized
    return final.argmax(dim=1), torch.from_numpy(lab_canvas).to(device)


def evaluate(forward, dataset, config, device, multi_scales: bool = False,
             window_batch: int | None = None, progbar: bool = True):
    """forward: images [n, 3, h, w] on ``device`` -> main logits [n, C, h, w].

    multi_scales: TTA over VAL.SCALE_RATIOS with a horizontal flip.
    progbar: show the reference's progress bar (val.py:190-191), on rank 0
    (its own batches).
    Returns the summary dict of ``MetricAccumulator`` plus ``val_time`` and
    ``images``."""
    num_classes = config.DATA.NUM_CLASSES
    ignore_index = config.TRAIN.IGNORE_INDEX
    batch_size = config.DATA.BATCH_SIZE_VAL
    crop_size = tuple(config.VAL.CROP_SIZE)
    stride_size = tuple(config.VAL.STRIDE_SIZE)
    acc = MetricAccumulator(num_classes, ignore_index)
    cm_total = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                           device=device)

    start = time.time()
    n_img = 0
    shard, n_shards = data_rank(), data_world()
    bar = None
    if progbar and is_main():
        from ..utils.progbar import Progbar
        own = sum(min(batch_size, len(dataset) - s)       # the images of rank 0's batches
                  for s in range(0, len(dataset), n_shards * batch_size))
        bar = Progbar(target=own, unit_name="img")
    for batch in val_batches(dataset, batch_size, shard, n_shards):
        imgs = [b[0] for b in batch]
        labels = [np.asarray(b[1]) for b in batch]
        n_real = len(imgs)
        # pad to the fixed batch size with copies (all-ignore labels)
        while len(imgs) < batch_size:
            imgs.append(imgs[-1])
            labels.append(np.full_like(labels[-1], ignore_index))
        if (len({im.shape[:2] for im in imgs}) == 1
                and len({lb.shape[-2:] for lb in labels}) == 1):
            img_batch = torch.from_numpy(np.stack(imgs)).to(device)
            img_batch = img_batch.permute(0, 3, 1, 2).contiguous()
            ori_shape = labels[0].shape[-2:]
            if multi_scales:
                pred = ms_inference(forward, img_batch, ori_shape, stride_size, crop_size,
                                    num_classes, window_batch,
                                    scales=config.VAL.SCALE_RATIOS, flip_horizontal=True)
            else:
                pred = ss_inference(forward, img_batch, ori_shape, stride_size, crop_size,
                                    num_classes, window_batch,
                                    base_size=config.VAL.IMAGE_BASE_SIZE,
                                    rescale_from_ori=config.VAL.RESCALE_FROM_ORI)
            label_batch = torch.from_numpy(np.stack(labels).reshape(pred.shape)).to(device)
        else:
            pred, label_batch = _variable_shape_predict(
                forward, imgs, labels, config, multi_scales, crop_size, stride_size,
                num_classes, ignore_index, window_batch, device)
        cm_total += confusion_matrix(pred, label_batch, num_classes, ignore_index)
        n_img += n_real
        if bar is not None:
            bar.update(n_img)

    if bar is not None and (bar.target is None or n_img < bar.target):
        # the loop's last update finalizes when n_img reaches the target;
        # only a short run is finalized here, so no line is written twice
        bar.update(n_img, finalize=True)
    if n_shards > 1:
        totals = all_reduce_data(torch.cat([cm_total.flatten(), cm_total.new_tensor([n_img])]))
        cm_total, n_img = totals[:-1].view_as(cm_total), int(totals[-1])
    cm = cm_total.cpu().numpy()
    acc.update_areas(np.diagonal(cm), cm.sum(axis=0), cm.sum(axis=1))
    val_time = time.time() - start
    result = acc.summarize()
    result["val_time"] = val_time
    result["images"] = n_img
    logger.info(
        f"[EVAL] #images: {n_img} mIoU: {result['miou']:.4f} "
        f"Acc: {result['acc']:.4f} Kappa: {result['kappa']:.4f} "
        f"mF1: {result['mf1']:.4f} ({val_time:.1f}s)")
    logger.info(f"[EVAL] class IoU: {np.round(result['class_iou'], 4)}")
    return result
