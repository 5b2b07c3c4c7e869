"""deform_fwd_roofline.slide: K1's share of its roofline over the eval
forwards, in %: the bytes of its inputs and output, each counted once from
the call shapes over the traced calls, at 3.35e12 bytes/s, over the device
time of the kernels named ``ms_deform_attn_fwd`` in the trace."""
from harness.yardstick import FWD_KERNEL, HBM_BYTES_S


def read(run):
    if run.get("kind") != "slide" or "trace" not in run:
        return None
    seconds = run["trace"].kernel_s(FWD_KERNEL)
    nbytes = run["tally"].bytes["fwd"]
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_S / seconds
