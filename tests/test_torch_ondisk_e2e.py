"""On-disk datasets end to end through the port (counterpart of
``tests/test_ondisk_e2e.py``, whose tree writers it imports): the
Vaihingen ``_noBoundary`` pairing with its label - 1 and 254 -> 255 remap
through ``emrt_tpu_torch.data.datasets.VaihingenISPRS``, the JAX loader's
arrays exactly; and a Potsdam-convention tree (train|test with
``*_convert_labels``, .tif images paired with .png labels in numeric order,
``10.tif`` after ``2.tif``) through ``python -m emrt_tpu_torch.train``,
``.val`` and ``.predict`` on the CPU with ``EMRT_smoke_synthetic.yaml``:
2 iterations with an eval and a save, ``best_model.pt``, ``final mIoU:``
and one colourised PNG per test image.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

pytest.importorskip("torch")

from emrt_tpu.data import datasets as jax_datasets  # noqa: E402
from emrt_tpu.data.transforms import Normalize as JaxNormalize  # noqa: E402
from test_ondisk_e2e import _write_potsdam_tree, _write_vaihingen_tree  # noqa: E402
from test_torch_slice import ROOT, _clean_env  # noqa: E402

from emrt_tpu_torch.data.datasets import Potsdam, VaihingenISPRS  # noqa: E402
from emrt_tpu_torch.data.transforms import Normalize  # noqa: E402

CONFIG = os.path.join("configs", "EMRT", "EMRT_smoke_synthetic.yaml")


def test_vaihingen_isprs_loader_remap(tmp_path):
    """_noBoundary pairing + label - 1 / 254 -> 255 remap on real files, as
    the JAX loader reads them."""
    _write_vaihingen_tree(str(tmp_path))
    ds = VaihingenISPRS([Normalize()], dataset_root=str(tmp_path), mode="train")
    assert len(ds) == 1
    assert ds.file_list[0][1].endswith("area1_noBoundary.png")
    img, lab = ds.get(0, rng=np.random.default_rng(0))
    assert img.shape == (64, 64, 3) and img.dtype == np.float32
    assert lab.shape == (64, 64)
    assert set(np.unique(lab)) <= set(range(6)) | {255}
    assert (lab[:3] == 255).all()   # void row -> ignore
    stored = np.asarray(Image.open(ds.file_list[0][1]))
    np.testing.assert_array_equal(lab[3:], stored[3:].astype(np.int64) - 1)
    want = jax_datasets.VaihingenISPRS([JaxNormalize()], dataset_root=str(tmp_path),
                                       mode="train").get(0, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(img, want[0])
    np.testing.assert_array_equal(lab, want[1])
    _, lab_v = VaihingenISPRS([Normalize()], dataset_root=str(tmp_path), mode="val").get(0)
    assert set(np.unique(lab_v)) <= set(range(6)) | {255}


def test_potsdam_pairs_sort_numerically(tmp_path):
    _write_potsdam_tree(str(tmp_path))
    names = [os.path.basename(img) for img, _ in
             Potsdam([Normalize()], dataset_root=str(tmp_path), mode="train").file_list]
    assert names == ["1.tif", "2.tif", "3.tif", "10.tif"]


def _run(module, args):
    out = subprocess.run([sys.executable, "-m", f"emrt_tpu_torch.{module}", "--config", CONFIG,
                          "--device", "cpu", *args], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=600)
    log = out.stdout + out.stderr
    assert out.returncode == 0, log[-3000:]
    return log


def test_potsdam_tree_through_the_clis(tmp_path):
    """train 2 iterations + val + predict over a Potsdam-convention tree."""
    data_root = str(tmp_path / "potsdam")
    os.makedirs(data_root)
    _write_potsdam_tree(data_root)
    save_dir = str(tmp_path / "run")
    common = ["DATA.DATASET", "Potsdam", "DATA.DATA_PATH", data_root,
              "DATA.BATCH_SIZE", "2", "DATA.BATCH_SIZE_VAL", "2", "TRAIN.DTYPE", "float32"]

    log = _run("train", ["--iters", "2", "SAVE_DIR", save_dir, "VALIDATE_FREQ", "2",
                         "SAVE_FREQ_CHECKPOINT", "2", "LOGGING_INFO_FREQ", "1", *common])
    assert "[EVAL]" in log and "mIoU" in log and "#images: 2" in log
    best = os.path.join(save_dir, "best_model.pt")
    assert os.path.isfile(best)

    log = _run("val", ["--model_path", best, *common])
    assert "final mIoU:" in log

    out_dir = str(tmp_path / "preds")
    _run("predict", ["--model_path", best, "--out_dir", out_dir, *common])
    pngs = sorted(os.listdir(out_dir))
    assert len(pngs) == 2 and all(p.endswith(".png") for p in pngs)
    arr = np.asarray(Image.open(os.path.join(out_dir, pngs[0])).convert("RGB"))
    assert arr.ndim == 3 and arr.shape[2] == 3   # colourised palette dump
    assert len(np.unique(arr.reshape(-1, 3), axis=0)) > 1
