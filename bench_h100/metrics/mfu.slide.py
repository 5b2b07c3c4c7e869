"""mfu.slide: a ``slide_inference`` call's share of the card's bf16 peak, in
%: the operations of one call (every window's eval forward: matmuls and
convolutions by ``FlopCounterMode``, plus K1's from its call shapes) times
the traced calls, over the traced window and the peak of 989e12 FLOP/s."""
from harness.yardstick import PEAK_BF16_FLOPS


def read(run):
    if (run.get("kind") != "slide" or not run.get("ops_per_unit")
            or run["trace"].busy_s <= 0):
        return None
    trace = run["trace"]
    return 100.0 * run["ops_per_unit"] * run["traced_units"] / trace.window_s / PEAK_BF16_FLOPS
