"""How far float32 lands from float64 in the narrow ResNeSt-50 EMRT's train
step of ``tests/test_torch_spatial_backbones.py`` (1 encoder and 1 decoder
layer, crop 64, two images, torch's seed 0), in one process and as dp1 x sp2
on two gloo ranks on the CPU, with dropout 0.1 and off: for each step its
loss, gradient norm before the clip and clipped gradients (L2) against one
process's float64 step on the same batch. Why that test holds ResNeSt in
float64.

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python3 scripts/torch_resnest_precision.py
"""
from __future__ import annotations

import numpy as np
from test_torch_spatial_ranks import calls_rank, grid_step_rank
from test_torch_spatial_train import _batch

from emrt_tpu_torch.parallel.launch import run_ranks

DTYPES = ("float32", "float64")


def _flat(result):
    return np.concatenate([v.ravel().astype(np.float64) for v in result["grads"].values()])


def main():
    image, label = _batch(2)
    for dropout in (0.1, 0.0):
        one = {dt: grid_step_rank(0, 1, 1, 1, "resnest", None, image, label, dropout, dtype=dt)
               for dt in DTYPES}
        calls = [(grid_step_rank, (1, 2, "resnest", None, image, label, dropout, None, 0, dt))
                 for dt in DTYPES]
        sp = dict(zip(DTYPES, run_ranks(calls_rank, 2, args=(calls,), timeout=900)[0]))
        exact = one["float64"]
        for name, got in (("one process float32", one["float32"]),
                          ("dp1 x sp2 float32", sp["float32"]),
                          ("dp1 x sp2 float64", sp["float64"])):
            g, w = _flat(got), _flat(exact)
            print(f"dropout {dropout}: {name} against one process's float64: loss "
                  f"{abs(got['loss'] - exact['loss']) / abs(exact['loss']):.3e} apart, norm "
                  f"{got['norm']:.6g} against {exact['norm']:.6g}, gradients "
                  f"{np.linalg.norm(g - w) / np.linalg.norm(w):.3e} apart (L2)", flush=True)


if __name__ == "__main__":
    main()
