"""flash_prefill_roofline: the prefill attention kernel's share of its
roofline over the traced encode span, in %: causal attention over the keys
each chunk's queries truly attend (not the power-of-2 cap the program
computes over), with the K/V read once, over the device time of
prefill_mma_kernel."""

from portbench import roofline

KERNEL = "prefill_mma_kernel"


def read(run):
    t, pk = run.trace, roofline.peaks(run.device_name, run.chips)
    if t is None or t.part != "encode" or pk is None:
        return None
    seconds = t.kernel_seconds(lambda n: KERNEL in n)
    if seconds <= 0:
        return None
    bound = sum(roofline.bound_s(roofline.attention_parts(run.sizes, f), pk)
                for f in roofline.job_encode_forwards(t.job))
    return 100.0 * bound / seconds
