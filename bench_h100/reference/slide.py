"""The reference sliding-window inference: windows of ``crop`` at origins
every ``stride`` pixels, the last row and column clamped to the image's
edge (duplicates dropped), each window's logits added into a float32 sum
canvas and divided by how many windows cover each pixel. ``crop`` and
``stride`` are (w, h), as in the configurations."""
from __future__ import annotations

import torch


def window_grid(img_h: int, img_w: int, crop, stride):
    (w_crop, h_crop), (w_stride, h_stride) = crop, stride
    rows = max(img_h - h_crop + h_stride - 1, 0) // h_stride + 1
    cols = max(img_w - w_crop + w_stride - 1, 0) // w_stride + 1
    out = []
    for r in range(rows):
        for c in range(cols):
            hw = (min(r * h_stride, max(img_h - h_crop, 0)),
                  min(c * w_stride, max(img_w - w_crop, 0)))
            if hw not in out:
                out.append(hw)
    return out


@torch.no_grad()
def slide(forward, imgs, crop, stride, num_classes: int, windows_a_call: int | None = None):
    """[bs, C, H, W] float32 logits; ``forward`` maps windows to their
    logits, ``windows_a_call`` windows of one image at a time (all by
    default)."""
    bs, _, img_h, img_w = imgs.shape
    w_crop, h_crop = min(crop[0], img_w), min(crop[1], img_h)
    coords = window_grid(img_h, img_w, (w_crop, h_crop), stride)
    step = windows_a_call or len(coords)
    canvas = torch.zeros((bs, num_classes, img_h, img_w), dtype=torch.float32,
                         device=imgs.device)
    count = torch.zeros((1, 1, img_h, img_w), dtype=torch.float32, device=imgs.device)
    for i in range(0, len(coords), step):
        chunk = coords[i:i + step]
        logits = forward(torch.cat([imgs[:, :, h:h + h_crop, w:w + w_crop]
                                    for h, w in chunk])).float()
        for j, (h, w) in enumerate(chunk):
            canvas[:, :, h:h + h_crop, w:w + w_crop] += logits[j * bs:(j + 1) * bs]
            count[:, :, h:h + h_crop, w:w + w_crop] += 1.0
    return canvas / count
