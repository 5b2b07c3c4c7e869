"""mfu.train: the train step's share of the card's bf16 peak, in %: the
operations of one step (matmuls and convolutions of the forward and the
backward by ``FlopCounterMode``, plus the deformable kernels' from their
call shapes; ``harness/yardstick.py``) times the traced steps, over the
traced window and the peak of 989e12 FLOP/s."""
from harness.yardstick import PEAK_BF16_FLOPS


def read(run):
    if (run.get("kind") != "train" or not run.get("ops_per_unit")
            or run["trace"].busy_s <= 0):
        return None
    trace = run["trace"]
    return 100.0 * run["ops_per_unit"] * run["traced_units"] / trace.window_s / PEAK_BF16_FLOPS
