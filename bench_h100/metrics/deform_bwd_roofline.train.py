"""deform_bwd_roofline.train: the fused K2 + K3 backward's share of its
roofline, in %: the bytes of its inputs and outputs, each counted once from
the call shapes over the traced steps, at 3.35e12 bytes/s, over the
device time of the kernels named ``ms_deform_attn_bwd`` in the trace."""
from harness.yardstick import BWD_KERNEL, HBM_BYTES_S


def read(run):
    if run.get("kind") != "train" or "trace" not in run:
        return None
    seconds = run["trace"].kernel_s(BWD_KERNEL)
    nbytes = run["tally"].bytes["bwd"]
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_S / seconds
