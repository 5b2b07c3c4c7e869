"""The train, val and predict entry points on a Potsdam yaml of each zoo
family (SETR-MLA: its ADE20K yaml), on the CPU at a small size (synthetic data, 32^2 crops, narrow
widths, few layers): two training iterations with a save and an
evaluation, then ``val`` on best_model.pt gives the training run's mIoU
exactly (F6) and ``predict`` writes a PNG per image from it.
"""
from __future__ import annotations

import io
from contextlib import redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from emrt_tpu_torch.predict import main as predict_main  # noqa: E402
from emrt_tpu_torch.train import main as train_main  # noqa: E402
from emrt_tpu_torch.val import main as val_main  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "DATA.DATASET", "Synthetic", "TRAIN.DTYPE", "float32",
         "DATA.BATCH_SIZE", "2", "DATA.CROP_SIZE", "(32, 32)", "VAL.IMAGE_BASE_SIZE", "32",
         "VAL.CROP_SIZE", "(32, 32)", "VAL.STRIDE_SIZE", "(32, 32)", "DATA.BATCH_SIZE_VAL",
         "16", "LOGGING_INFO_FREQ", "1"]
_VIT = ["MODEL.TRANS.HIDDEN_SIZE", "32", "MODEL.TRANS.NUM_LAYERS", "4",
        "MODEL.TRANS.NUM_HEADS", "2", "MODEL.ENCODER.OUT_INDICES", "(0, 1, 2, 3)"]
_UPER = ["MODEL.TRANS.EMBED_DIM", "16", "MODEL.TRANS.STAGE_DEPTHS", "(2, 2, 1, 1)",
         "MODEL.UPERHEAD.CHANNELS", "16"]
YAMLS = {
    "setr/SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml": _VIT,
    "setr/SETR_Naive_Large_256x256_160k_potsdam_bs_8.yaml": _VIT,
    "setr/SETR_MLA_Large_512x512_160k_ade20k_bs_8.yaml":
        _VIT + ["MODEL.MLA.MLA_CHANNELS", "16", "MODEL.MLA.MLAHEAD_CHANNELS", "8"],
    "upernet_swin/upernet_swin_tiny_patch4_windown7_512x512_160k_potsdam.yaml":
        _UPER + ["MODEL.TRANS.NUM_HEADS", "(1, 2, 4, 8)", "MODEL.TRANS.WINDOW_SIZE", "3"],
    "upernet_cswin/upernet_cswin_tiny_patch4_512x512_160k_potsdam.yaml":
        _UPER + ["MODEL.TRANS.NUM_HEADS", "(2, 4, 8, 8)", "MODEL.TRANS.SPLIT_SIZES",
                 "(1, 2, 2, 2)"],
    "upernet_focal/upernet_focal_base_patch4_windown7_512x512_160k_potsdam.yaml":
        _UPER + ["MODEL.TRANS.NUM_HEADS", "(1, 2, 4, 8)", "MODEL.TRANS.WINDOW_SIZE", "3"],
    "dpt/DPT_Large_512x512_160k_potsdam_bs_8.yaml":
        _VIT + ["MODEL.DPT.HIDDEN_FEATURES", "(8, 16, 32, 32)", "MODEL.DPT.FEATURES", "8"],
    "trans2seg/Trans2Seg_medium_256x256_160k_potsdam.yaml":
        ["MODEL.TRANS2SEG.EMBED_DIM", "32", "MODEL.TRANS2SEG.DEPTH", "1",
         "MODEL.TRANS2SEG.NUM_HEADS", "4", "MODEL.TRANS2SEG.HID_DIM", "8"],
}


@pytest.mark.parametrize("yaml", list(YAMLS))
def test_train_val_predict_a_zoo_yaml(yaml, tmp_path):
    config = ["--config", str(ROOT / "configs" / yaml)]
    opts = SMALL + YAMLS[yaml]
    save = ["SAVE_DIR", str(tmp_path), "SAVE_FREQ_CHECKPOINT", "2", "VALIDATE_FREQ", "2"]
    with redirect_stdout(io.StringIO()):
        run = train_main([*config, "--iters", "2", *opts, *save])
        assert run["steps"] == 2 and len(run["mious"]) == 1 and len(run["losses"]) == 2
        assert all(0 < loss < 100 for loss in run["losses"])
        result = val_main([*config, "--model_path", str(tmp_path / "best_model.pt"), *opts])
        assert result["miou"] == run["mious"][0]
        assert result["forwards"] == 64 // 16 and result["cost"]["flops"] > 0
        got = predict_main([*config, "--model_path", str(tmp_path / "best_model.pt"),
                            "--out_dir", str(tmp_path / "preds"), *opts])
    assert got["forwards"] == 4 and len(got["files"]) == 64
    assert all(Path(f).exists() for f in got["files"])
